"""Static per-op cost model and roofline analysis over traces.

The counterpart of ``thunder_tpu/analysis/cost.py``, for the card: every
value-producing BoundSymbol is assigned operations and device-memory bytes
from its tensor metadata alone, and scored against a device spec (peak
operation rate by type, memory bandwidth) to give per-op and whole-trace
roofline lower bounds: ``t_op >= max(ops / peak, bytes / bandwidth)``.

Conventions (the JAX package's, so that the two agree on the same program):

- matmul/linear: ``2·m·n·k`` (multiply and add), bias adds counted;
- elementwise: 1 operation an output element; reductions 1 an input
  element (variance 2); fills 1 an output element;
- layout ops (reshape, squeeze, broadcast) free; data-moving shape ops
  (transpose, cat, pad, take, ...) charged their bytes in and out;
- collectives: no operations and no memory bytes, and the ring's wire bytes
  a rank sends: ``2(g-1)/g`` of the tensor for an all-reduce, ``(g-1)/g``
  of the full tensor for an all-gather (an fsdp ``synchronize``) or
  reduce-scatter, at the link rate ``ici_bw`` or a family's fitted rate
  (:func:`calibrate_ici`).

The port's kernel claims are costed by the formulas of ``chip_smoke.py``'s
``bound()`` rows (``PERF.md`` §6), so that the table's bound is read off
this module (:func:`kernel_costs` gives a claim's kernels one by one, a
claim that launches several, the int8 linear, being their sum):

- flash attention (``csrc/flash_attn.cu``, ``flash_bwd*.cu``): 4 operations
  per (query, key) pair, head dim and head for the forward, 10 for the
  backward from saved residuals, 4 + 10 for the recompute backward, in bf16
  on the tensor cores; pairs are the causal triangle (or the full square)
  of the shapes, or ``valid_pairs`` where the caller knows the mask's data.
  Bytes: q, k, v and out (and lse, dout, dq, dk, dv) once each; a masked
  claim reads segment ids (4 bytes a query and a key), not the mask;
- rope (``csrc/rope.cu``): 3 f32 operations an element; x, cos, sin, out;
- cross-entropy (``csrc/cross_entropy.cu``): 4 f32 operations a logit
  forward (the per-row losses written), 5 backward (a row scale read);
- RMSNorm/LayerNorm (``csrc/norm.cu``): 6 f32 operations an element
  forward, 12 backward; the backward writes dw (and db) in f32;
- the keyed draw (``csrc/rng.cu``): 76 int32 operations an element (the
  threefry rounds), the key's 16 bytes and the output;
- the int8 linear (``csrc/quantize.cu``, ``csrc/int8_gemm.cu``): each
  quantization 4 f32 operations an element, reading the operand and writing
  int8 and the scales; the product ``2·M·N·K`` int8 operations, reading both
  int8 operands and the scales, writing the output.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from thunder_tpu_torch.core.prims import OpTags, PrimIDs
from thunder_tpu_torch.core.proxies import TensorProxy, pyval
from thunder_tpu_torch.core.trace import TraceCtx

# =============================================================================
# Device specs
# =============================================================================


@dataclass(frozen=True)
class DeviceSpec:
    """Peak numbers for one card. ``peak_flops`` maps an arithmetic class
    ("bf16": the tensor cores' f16/bf16 rate, "f32" outside them, "int8" the
    tensor cores' int8 rate, "int32" the integer units) to operations a
    second; ``hbm_bw`` is bytes a second, ``hbm_bytes`` the memory (0:
    unknown). ``ici_bw`` is the link rate between cards a second (the JAX
    package's name; NVLink here), ``dcn_bw`` that of the slower tier between
    hosts (0: none, priced at ``ici_bw``), and ``ici_class_bw`` the rates
    :func:`calibrate_ici` fitted a collective family (None: the link rate).
    Datasheet values: real kernels see less, so the roofline is a lower
    bound."""

    name: str
    peak_flops: dict[str, float]
    hbm_bw: float
    hbm_bytes: float = 0.0
    ici_bw: float = 0.0
    dcn_bw: float = 0.0
    ici_class_bw: Optional[dict] = None

    def peak_for(self, dtype_class: Any) -> float:
        if not isinstance(dtype_class, str):
            dtype_class = _dtype_class(dtype_class)
        return self.peak_flops.get(dtype_class, self.peak_flops["bf16"])

    def ici_bw_for(self, cls: Optional[str]) -> float:
        """The rate a collective of family ``cls`` ("all-gather", ...) is
        priced at: its fitted rate when there is one, else ``ici_bw``."""
        if cls and self.ici_class_bw and self.ici_class_bw.get(cls):
            return float(self.ici_class_bw[cls])
        return self.ici_bw

    @property
    def dcn_bw_or_ici(self) -> float:
        return self.dcn_bw or self.ici_bw


def _dtype_class(dtype: Any) -> str:
    nbytes = getattr(dtype, "bytes", 4)
    if getattr(dtype, "kind", "float") in ("int", "uint", "bool"):
        return "int8" if nbytes <= 1 else "int32"
    return "bf16" if nbytes <= 2 else "f32"


# NVIDIA's H100 SXM datasheet, dense rates: 989 TFLOP/s bf16, 67 TFLOP/s f32
# outside the tensor cores, 1,979 TOP/s int8, 3.35 TB/s, 80 GB; the int32
# rate is 132 SMs x 128 integer lanes x 1.98 GHz (the boost clock), as
# chip_smoke.py prices the draw kernel. The link rate is the same
# datasheet's NVLink 4 figure, 900 GB/s a GPU counting both directions: a
# ring sends one way, 450 GB/s. The card has no second tier (dcn_bw 0).
# "cpu" is a small spec so that host-side plans still classify; its memory
# is unknown (0).
DEVICE_SPECS: dict[str, DeviceSpec] = {
    "h100": DeviceSpec("h100", {"bf16": 989e12, "f32": 67e12, "int8": 1979e12, "int32": 132 * 128 * 1.98e9},
                       hbm_bw=3.35e12, hbm_bytes=80e9, ici_bw=450e9),
    "cpu": DeviceSpec("cpu", {"bf16": 2e11, "f32": 2e11, "int8": 4e11, "int32": 2e11}, hbm_bw=5e10, hbm_bytes=0.0,
                      ici_bw=1e10, dcn_bw=1e9),
}


def collective_sym_class(sym_name: str) -> Optional[str]:
    """The collective family ("all-gather", "all-reduce", ...) of a
    trace-level collective symbol name, or None: the one map, shared with
    the measured half (``observability/attribution.py``)."""
    from thunder_tpu_torch.observability.attribution import COLLECTIVE_SYM_CLASS

    return COLLECTIVE_SYM_CLASS.get(sym_name)


def calibrate_ici(spec: DeviceSpec, samples: Sequence[tuple]) -> DeviceSpec:
    """Fit each collective family's rate from measured collectives
    (thunder_tpu/analysis/cost.py:153-182). ``samples`` are ``(family,
    wire bytes, measured seconds)`` rows, the wire bytes this model's; the
    fit is ``sum(bytes) / sum(seconds)`` a family, capped at the spec's
    ``ici_bw`` (a measurement can only show the wire slower than its
    datasheet). Returns a new spec whose :meth:`DeviceSpec.ici_bw_for`
    prices each family at its fitted rate."""
    import dataclasses

    by_cls: dict[str, list[float]] = {}
    for cls, comm_bytes, measured_s in samples:
        if not cls or not comm_bytes or not measured_s or measured_s <= 0:
            continue
        agg = by_cls.setdefault(str(cls), [0.0, 0.0])
        agg[0] += float(comm_bytes)
        agg[1] += float(measured_s)
    fitted = {cls: min(b / t, spec.ici_bw) if spec.ici_bw else b / t for cls, (b, t) in by_cls.items() if t > 0 and b > 0}
    if not fitted:
        return spec
    return dataclasses.replace(spec, ici_class_bw=fitted)


def resolve_device_spec(device: Any = None) -> DeviceSpec:
    """A :class:`DeviceSpec` from a spec, a table name, a torch device, or
    None: the card's own (``torch.cuda.get_device_name``) when there is one,
    else "cpu". A card missing from the table warns and is priced as an
    H100; a *named* unknown spec raises."""
    import torch

    if isinstance(device, DeviceSpec):
        return device
    if isinstance(device, str) and device.lower() not in ("cuda", "cpu") and not device.startswith("cuda:"):
        spec = DEVICE_SPECS.get(device.lower())
        if spec is None:
            raise ValueError(f"unknown device spec {device!r}; known: {sorted(DEVICE_SPECS)} (pass a DeviceSpec to "
                             "add a card)")
        return spec
    dev = torch.device(device) if isinstance(device, str) else device
    if isinstance(dev, torch.device) and dev.type == "cpu":
        return DEVICE_SPECS["cpu"]
    if not torch.cuda.is_available():
        return DEVICE_SPECS["cpu"]
    index = dev.index if isinstance(dev, torch.device) and dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    if "H100" not in name:
        warnings.warn(f"no DeviceSpec for the card {name!r}; roofline numbers use the H100 spec — pass "
                      "device=DeviceSpec(...) for its own bounds", stacklevel=2)
    return DEVICE_SPECS["h100"]


# =============================================================================
# Per-op cost rules
# =============================================================================


@dataclass
class OpCost:
    """Static cost of one op: operations, device-memory bytes (reads and
    writes), its kind, and the arithmetic class its operations run at
    (None: the class of its first tensor output's type)."""

    flops: float = 0.0
    bytes_moved: float = 0.0
    kind: str = "other"
    dtype_class: Optional[str] = None
    comm_bytes: float = 0.0  # bytes on the wire between cards, all tiers
    dcn_bytes: float = 0.0  # of which on the slower tier between hosts

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_moved if self.bytes_moved else float("inf")

    def seconds(self, spec: DeviceSpec, dtype: Any = None, cls: Optional[str] = None) -> tuple[float, str]:
        """``(bound seconds, "operations" | "bytes" | "comm" | "free")`` on
        ``spec``; a collective's wire bytes at the rate of its family
        ``cls``, the slower tier's at ``dcn_bw``."""
        t_ops = self.flops / spec.peak_for(self.dtype_class or dtype)
        t_bytes = self.bytes_moved / spec.hbm_bw
        bw = spec.ici_bw_for(cls)
        t_comm = ((self.comm_bytes - self.dcn_bytes) / bw + self.dcn_bytes / spec.dcn_bw_or_ici) if (
            self.comm_bytes and bw) else 0.0
        t = max(t_ops, t_bytes, t_comm)
        if t == 0.0:
            return 0.0, "free"
        return t, "comm" if t == t_comm else "bytes" if t == t_bytes else "operations"


def _tensor_args(bsym) -> list[TensorProxy]:
    return [p for p in bsym.flat_proxy_args if isinstance(p, TensorProxy)]


def _tensor_outs(bsym) -> list[TensorProxy]:
    return [p for p in bsym.flat_proxy_outs if isinstance(p, TensorProxy)]


def _int(x) -> int:
    v = pyval(x)
    return int(v if v is not None else x)


def _numel(shape: Sequence[Any]) -> int:
    return math.prod(_int(s) for s in shape)


def _bytes(ps) -> float:
    return float(sum(p.size_bytes for p in ps))


def _io_bytes(bsym) -> float:
    return _bytes(_tensor_args(bsym)) + _bytes(_tensor_outs(bsym))


def _out_numel(bsym) -> int:
    return sum(p.numel for p in _tensor_outs(bsym))


def _in_numel(bsym) -> int:
    return sum(p.numel for p in _tensor_args(bsym))


# Bookkeeping prims with no runtime cost at all.
_FREE_IDS = {
    PrimIDs.DEL, PrimIDs.RETURN, PrimIDs.COMMENT, PrimIDs.PRINT,
    PrimIDs.UNPACK_TRIVIAL, PrimIDs.UNPACK_SEQUENCE, PrimIDs.UNPACK_KEY,
    PrimIDs.UNPACK_ATTR, PrimIDs.UNPACK_DIM,
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    PrimIDs.CHECK_STRING_VALUE, PrimIDs.CHECK_LEN, PrimIDs.CHECK_KEYS,
    PrimIDs.CHECK_NONE, PrimIDs.CHECK_DIM_BUCKET,
    PrimIDs.SHALLOW_COPY, PrimIDs.STOP_GRADIENT, PrimIDs.ITEM,
}

_LAYOUT_IDS = {PrimIDs.RESHAPE, PrimIDs.SQUEEZE, PrimIDs.BROADCAST_IN_DIM}

_MOVE_IDS = {
    PrimIDs.TRANSPOSE, PrimIDs.CAT, PrimIDs.PAD, PrimIDs.SLICE, PrimIDs.FLIP,
    PrimIDs.TAKE, PrimIDs.TAKE_ALONG_AXIS, PrimIDs.GATHER, PrimIDs.SETITEM,
    PrimIDs.INDEX_PUT, PrimIDs.TENSOR_FROM_SEQUENCE, PrimIDs.DEVICE_PUT,
    PrimIDs.CONVERT_ELEMENT_TYPE, PrimIDs.COPY_, PrimIDs.TENSOR_CONSTANT,
}

_VAR_IDS = {PrimIDs.VAR, PrimIDs.VAR_MEAN}

_SDPA_IDS = {"torch.scaled_dot_product_attention", "torch.sdpa_fwd_res", "torch.sdpa_bwd", "torch.sdpa_bwd_res"}

# Operations an element of the draw kernel (csrc/rng.cu) and of the
# quantization kernels (csrc/quantize.cu), as chip_smoke.py prices them.
RNG_OPS_PER_ELEMENT = 76
QUANT_OPS_PER_ELEMENT = 4
_KEYED_DRAWS = {PrimIDs.UNIFORM_KEYED, PrimIDs.RANDN_KEYED}


def causal_pairs(Tq: int, Tkv: int) -> int:
    """(query, key) pairs that a causal mask aligned bottom-right keeps:
    query i sees keys up to i + Tkv - Tq."""
    return sum(max(0, min(Tkv, i + Tkv - Tq + 1)) for i in range(Tq))


def attention_cost(q: TensorProxy, k: TensorProxy, causal: bool, ops_per_pair: float, nbytes: float, *,
                   valid_pairs: Optional[int] = None) -> OpCost:
    """A flash kernel's cost: ``ops_per_pair`` bf16 operations a visible
    (query, key) pair, a head dim and a head (the pairs summed over the
    batch when ``valid_pairs`` is given, else the shapes' pairs a batch
    row), and ``nbytes``."""
    B, H, Tq, D = (_int(s) for s in q.shape)
    Tkv = _int(k.shape[-2])
    if valid_pairs is None:
        valid_pairs = B * (causal_pairs(Tq, Tkv) if causal else Tq * Tkv)
    return OpCost(flops=ops_per_pair * H * D * valid_pairs, bytes_moved=nbytes, kind="sdpa", dtype_class="bf16")


def _sdpa_claim(bsym, valid_pairs: Optional[int]) -> list:
    sid = bsym.sym.id
    if sid == "torch.sdpa_bwd":
        names = ("g", "query", "key", "value", "attn_mask", "is_causal")
    elif sid == "torch.sdpa_bwd_res":
        names = ("g", "query", "key", "value", "out", "lse", "attn_mask", "is_causal")
    elif sid == "torch.sdpa_fwd_res":
        names = ("query", "key", "value", "attn_mask", "is_causal")
    else:
        names = ("query", "key", "value", "attn_mask", "dropout_p", "is_causal")
    b = {"attn_mask": None, "is_causal": False, **dict(zip(names, bsym.args)), **bsym.kwargs}
    q, k, mask = b["query"], b["key"], b["attn_mask"]
    causal = bool(pyval(b["is_causal"]))
    if mask is not None:
        # A verdict of 1 (a verdict a slice under vmap, all 1) runs the full
        # square; any other, or none known, is costed at the causal pairs,
        # the fewer, so that the bound stays a lower bound.
        verdicts = b.get("verdict")
        verdicts = verdicts if isinstance(verdicts, tuple) else (verdicts,)
        causal = not all(v == 1 for v in verdicts)
    tensors = [t for t in _tensor_args(bsym) if t is not mask]
    nbytes = _bytes(tensors) + _bytes(_tensor_outs(bsym))
    if mask is not None:
        nbytes += 4.0 * _int(q.shape[0]) * (_int(q.shape[-2]) + _int(k.shape[-2]))  # segment ids, not the mask
    ops = {"torch.scaled_dot_product_attention": 4.0, "torch.sdpa_fwd_res": 4.0, "torch.sdpa_bwd_res": 10.0,
           "torch.sdpa_bwd": 4.0 + 10.0}[sid]
    return [(bsym.sym.name, attention_cost(q, k, causal, ops, nbytes, valid_pairs=valid_pairs))]


def _quant_linear_claim(bsym) -> list:
    from thunder_tpu_torch.executors import quantex

    a, w = bsym.args[0], bsym.args[1]
    bias = bsym.args[2] if len(bsym.args) > 2 and isinstance(bsym.args[2], TensorProxy) else bsym.kwargs.get("bias")
    K = _int(a.shape[-1])
    M, N = _numel(a.shape) // K, _int(w.shape[0])
    out = _tensor_outs(bsym)[0]
    per_channel = quantex.get_recipe().per_channel_weights

    def quant(x: TensorProxy, scales: int) -> OpCost:
        n = x.numel
        return OpCost(flops=QUANT_OPS_PER_ELEMENT * n, bytes_moved=float(x.size_bytes + n + 4 * scales),
                      kind="quant", dtype_class="f32")

    gemm = OpCost(flops=2.0 * M * N * K, bytes_moved=float(M * K + N * K + 4 * N + M * N * out.dtype.bytes
                                                            + (4 * N if bias is not None else 0)),
                  kind="int8_gemm", dtype_class="int8")
    return [("quantize_tensor", quant(a, 1)), ("quantize_rows" if per_channel else "quantize_tensor",
                                               quant(w, N if per_channel else 1)), ("int8_gemm", gemm)]


def kernel_costs(bsym, *, valid_pairs: Optional[int] = None) -> Optional[list]:
    """``[(kernel, OpCost), ...]`` of a claim of the port's kernel
    executors, a kernel a launch, by ``chip_smoke.py``'s bound formulas;
    None for any other op. ``valid_pairs``: the (query, key) pairs a masked
    attention's data leaves visible, where the caller knows them."""
    ex = bsym.sym.executor
    name = None if ex is None else ex.name
    sid = bsym.sym.id
    if name == "flash" and sid in _SDPA_IDS:
        return _sdpa_claim(bsym, valid_pairs)
    if name == "fused" and sid == "torch.apply_rope":
        return [("rope", OpCost(flops=3.0 * _out_numel(bsym), bytes_moved=_io_bytes(bsym), kind="rope",
                                dtype_class="f32"))]
    if name == "fused" and sid == "torch.cross_entropy":
        logits, target = bsym.args[0], bsym.args[1]
        N, V = _numel(logits.shape[:-1]), _int(logits.shape[-1])
        return [("ce_fwd", OpCost(flops=4.0 * N * V, bytes_moved=float(logits.size_bytes + target.size_bytes + 4 * N),
                                  kind="cross_entropy", dtype_class="f32"))]
    if name == "fused" and sid == "torch.cross_entropy_bwd":
        logits, target = bsym.args[1], bsym.args[2]
        N, V = _numel(logits.shape[:-1]), _int(logits.shape[-1])
        return [("ce_bwd", OpCost(flops=5.0 * N * V, bytes_moved=float(logits.size_bytes + _bytes(_tensor_outs(bsym))
                                                                       + target.size_bytes + 4 * N),
                                  kind="cross_entropy", dtype_class="f32"))]
    if name == "norm" and sid in ("torch.rms_norm", "torch.layer_norm"):
        x = bsym.args[0]
        tag = "ln_fwd" if sid == "torch.layer_norm" else "rms_fwd"
        return [(tag, OpCost(flops=6.0 * x.numel, bytes_moved=_io_bytes(bsym), kind="norm", dtype_class="f32"))]
    if name == "norm" and sid in ("torch.rms_norm_bwd", "torch.layer_norm_bwd"):
        g, x, w = bsym.args[0], bsym.args[1], bsym.args[2]
        params = 2 if sid == "torch.layer_norm_bwd" and isinstance(bsym.args[3], TensorProxy) else 1
        D = _int(w.shape[-1])
        nbytes = float(g.size_bytes + x.size_bytes + x.size_bytes + w.size_bytes + params * D * 4)
        tag = "ln_bwd" if sid == "torch.layer_norm_bwd" else "rms_bwd"
        return [(tag, OpCost(flops=12.0 * x.numel, bytes_moved=nbytes, kind="norm", dtype_class="f32"))]
    if name == "quant" and sid in ("torch.linear", PrimIDs.LINEAR):
        return _quant_linear_claim(bsym)
    if sid in _KEYED_DRAWS:
        n = _out_numel(bsym)
        return [("rng_draw", OpCost(flops=float(RNG_OPS_PER_ELEMENT * n), bytes_moved=_bytes(_tensor_outs(bsym)) + 16,
                                    kind="fill", dtype_class="int32"))]
    return None


def _matmul_cost(bsym) -> OpCost:
    a = _tensor_args(bsym)[0]
    return OpCost(flops=2.0 * _out_numel(bsym) * _int(a.shape[-1]), bytes_moved=_io_bytes(bsym), kind="matmul")


def _linear_cost(bsym) -> OpCost:
    tas = _tensor_args(bsym)
    out_n = _out_numel(bsym)
    flops = 2.0 * out_n * _int(tas[0].shape[-1]) + (out_n if len(tas) > 2 else 0)
    return OpCost(flops=flops, bytes_moved=_io_bytes(bsym), kind="matmul")


# Ring wire bytes a rank sends, as a factor of the tensor's bytes, by group
# size g (thunder_tpu/analysis/cost.py:305-316).
_COLLECTIVE_FACTORS: dict[str, Callable[[int], float]] = {
    "all_reduce": lambda g: 2.0 * (g - 1) / g,
    "all_gather": lambda g: (g - 1) / g,
    "reduce_scatter": lambda g: (g - 1) / g,
    "broadcast": lambda g: (g - 1) / g,
    "all_to_all": lambda g: (g - 1) / g,
    "ppermute": lambda g: 1.0,
    "mask_to_rank": lambda g: 0.0,
    "synchronize": lambda g: 0.0,
    "wait": lambda g: 0.0,
}

# The axis whose hops cross hosts, priced at the slower tier (the JAX
# package's parallel/mesh.DCN_AXIS).
_DCN_AXIS = "dcn"


def _hier_all_reduce_cost(bsym) -> OpCost:
    """The hierarchical all-reduce: reduce-scatter and all-gather within the
    inner group move ``2(g_in-1)/g_in`` of the bytes; the outer all-reduce
    moves ``2(g_out-1)/g_out`` of the ``1/g_in`` shard, on the slower tier."""
    nbytes = _bytes(_tensor_args(bsym))
    g_in = _int(bsym.args[3] if len(bsym.args) > 3 else bsym.kwargs.get("inner_size", 1))
    g_out = _int(bsym.args[4] if len(bsym.args) > 4 else bsym.kwargs.get("outer_size", 1))
    inner = 2.0 * (g_in - 1) / g_in * nbytes if g_in > 1 else 0.0
    outer = 2.0 * (g_out - 1) / g_out * nbytes / max(1, g_in) if g_out > 1 else 0.0
    return OpCost(comm_bytes=inner + outer, dcn_bytes=outer, kind="collective")


def collective_group_size(bsym) -> int:
    """The ranks a collective line spans: its first int argument above 1
    (the prims take the axis's size after the axis), else 1."""
    return next((v for v in (pyval(a) for a in bsym.flat_args)
                 if isinstance(v, int) and not isinstance(v, bool) and v > 1), 1)


def _collective_cost(bsym) -> OpCost:
    """A collective's wire bytes: the ring factor of its family times its
    tensor's bytes (the full, gathered tensor's for a gather, which a
    sharded ``synchronize`` is). Nothing on the device's memory: the bytes
    the collective moves there are its kernel's, not the program's."""
    name = bsym.sym.name
    if name == "hier_all_reduce":
        return _hier_all_reduce_cost(bsym)
    nbytes = _bytes(_tensor_args(bsym))
    axis = bsym.args[1] if len(bsym.args) > 1 else bsym.kwargs.get("axis")
    on_dcn = axis == _DCN_AXIS
    factor = _COLLECTIVE_FACTORS.get(name)
    if factor is None:
        return OpCost(comm_bytes=nbytes, dcn_bytes=nbytes if on_dcn else 0.0, kind="collective")
    g = collective_group_size(bsym)
    if name in ("all_gather", "synchronize"):
        out_bytes = _bytes(_tensor_outs(bsym))
        if out_bytes > nbytes:
            wire = (g - 1) / g * out_bytes
            return OpCost(comm_bytes=wire, dcn_bytes=wire if on_dcn else 0.0, kind="collective")
    wire = factor(g) * nbytes
    return OpCost(comm_bytes=wire, dcn_bytes=wire if on_dcn else 0.0, kind="collective")


def bsym_cost(bsym, *, valid_pairs: Optional[int] = None) -> Optional[OpCost]:
    """Static cost of one BoundSymbol, or None for pure bookkeeping. A
    kernel claim's cost is the sum of :func:`kernel_costs` (its operations
    at the class of its largest part)."""
    kernels = kernel_costs(bsym, valid_pairs=valid_pairs)
    if kernels is not None:
        total = OpCost(kind=kernels[-1][1].kind, dtype_class=max(kernels, key=lambda kc: kc[1].flops)[1].dtype_class)
        for _, c in kernels:
            total.flops += c.flops
            total.bytes_moved += c.bytes_moved
        return total
    sid = bsym.sym.id
    if sid in _FREE_IDS:
        return None
    if OpTags.COMM_OP in bsym.sym.tags:
        return _collective_cost(bsym)
    if sid is PrimIDs.MATMUL:
        return _matmul_cost(bsym)
    if sid is PrimIDs.LINEAR:
        return _linear_cost(bsym)
    if sid in (PrimIDs.EMBEDDING, PrimIDs.EMBEDDING_BACKWARD):
        return OpCost(bytes_moved=_io_bytes(bsym), kind="gather")
    if sid in _LAYOUT_IDS:
        return OpCost(kind="layout")
    if sid in _MOVE_IDS:
        return OpCost(bytes_moved=_io_bytes(bsym), kind="shape")
    if not _tensor_outs(bsym):
        return None
    tags = bsym.sym.tags
    if OpTags.REDUCTION_OP in tags or sid in _VAR_IDS or sid in (
            PrimIDs.SUM, PrimIDs.PROD, PrimIDs.AMAX, PrimIDs.AMIN, PrimIDs.ARGMAX, PrimIDs.ARGMIN, PrimIDs.CUMSUM,
            PrimIDs.CUMPROD):
        return OpCost(flops=(2.0 if sid in _VAR_IDS else 1.0) * _in_numel(bsym), bytes_moved=_io_bytes(bsym),
                      kind="reduction")
    if sid in (PrimIDs.SORT, PrimIDs.ARGSORT, PrimIDs.TOPK):
        return OpCost(flops=float(_in_numel(bsym)), bytes_moved=_io_bytes(bsym), kind="sort")
    if sid in (PrimIDs.FULL, PrimIDs.IOTA, PrimIDs.UNIFORM, PrimIDs.RANDN):
        return OpCost(flops=float(_out_numel(bsym)), bytes_moved=_bytes(_tensor_outs(bsym)), kind="fill")
    kind = "elementwise" if (OpTags.ELEMENTWISE_UNARY_OP in tags or OpTags.ELEMENTWISE_BINARY_OP in tags
                             or sid is PrimIDs.WHERE) else "other"
    return OpCost(flops=float(_out_numel(bsym)), bytes_moved=_io_bytes(bsym), kind=kind)


# =============================================================================
# Trace rollup and roofline
# =============================================================================


@dataclass
class OpCostRow:
    """One trace line's cost, scored against the device spec."""

    index: int
    sym: str
    kind: str
    flops: float
    bytes_moved: float
    roofline_s: float
    bound: str  # "operations" | "bytes" | "comm" | "free"
    intensity: float
    executor: Optional[str] = None
    line: str = ""
    comm_bytes: float = 0.0
    compute_s: float = 0.0  # its operations at their class's peak, every byte free


@dataclass
class TraceCost:
    """Cost rollup of one trace against one device spec."""

    device: DeviceSpec
    rows: list[OpCostRow] = field(default_factory=list)
    total_flops: float = 0.0
    total_bytes: float = 0.0
    total_comm_bytes: float = 0.0
    total_dcn_bytes: float = 0.0  # of total_comm_bytes, on the slower tier
    compute_s: float = 0.0  # every byte free, each op at its own class's peak

    @property
    def roofline_s(self) -> float:
        """Lower bound with no fusion across ops: the sum of per-op bounds."""
        return sum(r.roofline_s for r in self.rows)

    @property
    def memory_s(self) -> float:
        return self.total_bytes / self.device.hbm_bw

    @property
    def comm_s(self) -> float:
        """Every wire byte at the link rate (the slower tier's at its own);
        0 without collectives or a link rate."""
        if not self.total_comm_bytes or not self.device.ici_bw:
            return 0.0
        return ((self.total_comm_bytes - self.total_dcn_bytes) / self.device.ici_bw
                + self.total_dcn_bytes / self.device.dcn_bw_or_ici)

    def collective_rows(self) -> list[OpCostRow]:
        """The trace's collectives: the predicted half of the collective
        rows of ``observability/attribution.py``."""
        return [r for r in self.rows if r.kind == "collective"]

    def by_kind(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for r in self.rows:
            d = out.setdefault(r.kind, {"flops": 0.0, "bytes": 0.0, "roofline_s": 0.0, "ops": 0})
            d["flops"] += r.flops
            d["bytes"] += r.bytes_moved
            d["roofline_s"] += r.roofline_s
            d["ops"] += 1
        return out

    def top(self, k: int = 10) -> list[OpCostRow]:
        return sorted(self.rows, key=lambda r: r.roofline_s, reverse=True)[:k]

    def format(self, top_k: int = 10) -> str:
        dev = self.device
        lines = [
            f"cost model [{dev.name}: {dev.peak_flops['bf16'] / 1e12:.0f} bf16 TFLOP/s, {dev.hbm_bw / 1e9:.0f} GB/s]",
            f"  total: {self.total_flops / 1e9:.3f} GFLOP, {self.total_bytes / 1e6:.2f} MB moved"
            + (f", {self.total_comm_bytes / 1e6:.2f} MB on the wire" if self.total_comm_bytes else ""),
            f"  roofline bound: {self.roofline_s * 1e3:.3f} ms unfused (compute {self.compute_s * 1e3:.3f} ms, "
            f"memory {self.memory_s * 1e3:.3f} ms)",
            f"  {'line':>5} {'sym':<28} {'kind':<14} {'GFLOP':>10} {'MB':>9} {'bound':>10} {'us':>9}",
        ]
        for r in self.top(top_k):
            lines.append(f"  L{r.index:>4} {r.sym:<28.28} {r.kind:<14} {r.flops / 1e9:>10.4f} "
                         f"{r.bytes_moved / 1e6:>9.3f} {r.bound:>10} {r.roofline_s * 1e6:>9.1f}")
        kinds = self.by_kind()
        if kinds:
            lines.append("  by kind: " + ", ".join(f"{k}={v['roofline_s'] * 1e6:.0f}us/{v['ops']}ops" for k, v in
                                                   sorted(kinds.items(), key=lambda kv: -kv[1]["roofline_s"])))
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format()


def trace_cost(trace: TraceCtx, device: Any = None) -> TraceCost:
    """Roll :func:`bsym_cost` up over ``trace`` and score each op against
    ``device`` (a :class:`DeviceSpec`, a name of ``DEVICE_SPECS``, a torch
    device, or None for the local card). A kernel claim's bound is the sum
    of its kernels' bounds."""
    dev = resolve_device_spec(device)
    tc = TraceCost(device=dev)
    for i, bsym in enumerate(trace.bound_symbols):
        c = bsym_cost(bsym)
        if c is None:
            continue
        row = cost_row(i, bsym, dev, c)
        row.line = bsym.one_line()
        tc.rows.append(row)
        tc.compute_s += row.compute_s
        tc.total_flops += c.flops
        tc.total_bytes += c.bytes_moved
        tc.total_comm_bytes += c.comm_bytes
        tc.total_dcn_bytes += c.dcn_bytes
    return tc


def cost_row(index: int, bsym, dev: DeviceSpec, c: Optional[OpCost] = None) -> Optional[OpCostRow]:
    """The :class:`OpCostRow` of trace line ``index`` on ``dev`` (its line
    text left empty), or None for bookkeeping: one row of
    :func:`trace_cost`, for a caller that prices a few lines of a trace."""
    c = bsym_cost(bsym) if c is None else c
    if c is None:
        return None
    outs = _tensor_outs(bsym)
    dtype = outs[0].dtype if outs else None
    parts = kernel_costs(bsym) or [(bsym.sym.name, c)]
    cls = collective_sym_class(bsym.sym.name) if c.comm_bytes else None
    t = sum(p.seconds(dev, dtype, cls)[0] for _, p in parts)
    bound = "free" if t == 0.0 else max((p.seconds(dev, dtype, cls) for _, p in parts))[1]
    ex = bsym.sym.executor
    return OpCostRow(index=index, sym=bsym.sym.name, kind=c.kind, flops=c.flops, bytes_moved=c.bytes_moved,
                     roofline_s=t, bound=bound, intensity=c.arithmetic_intensity,
                     executor=None if ex is None else ex.name, comm_bytes=c.comm_bytes,
                     compute_s=sum(p.flops / dev.peak_for(p.dtype_class or dtype) for _, p in parts))


def cost_report(fn: Callable, *args, executors: Any = None, device: Any = None, **kwargs) -> TraceCost:
    """The :class:`TraceCost` of the execution trace ``fn`` compiles to on
    the example inputs (``liveness.claimed_trace``). ``examine.cost_report``
    re-exports this; to cost the trace an entry ran, call :func:`trace_cost`
    on ``last_traces(jfn)[-1]``."""
    from thunder_tpu_torch.analysis.liveness import claimed_trace

    return trace_cost(claimed_trace(fn, args, kwargs, executors), device)


# =============================================================================
# Device-op pricing (the compiled-program auditor's; thunder_tpu/analysis/cost.py:680-777)
# =============================================================================

# Ring wire factors by collective family, the JAX package's HLO names: the
# compiled-program counterpart of _COLLECTIVE_FACTORS.
HLO_COLLECTIVE_FACTORS: dict[str, Callable[[int], float]] = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "collective-broadcast": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "ragged-all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def hlo_collective_wire_bytes(family: str, full_bytes: float, group_size: int) -> float:
    """Ring wire traffic of one collective op: the family's factor applied to
    the full tensor's bytes (a gather's output, a reduction's input)."""
    factor_fn = HLO_COLLECTIVE_FACTORS.get(family)
    if factor_fn is None or group_size <= 1:
        return full_bytes if factor_fn is not None else 0.0
    return factor_fn(group_size) * full_bytes


# Opcode classes, the JAX package's: layout-only ops are free, data movers
# are charged their bytes in and out, elementwise ops 1 operation an output
# element, reductions 1 an input element.
_HLO_FREE_OPS = frozenset({
    "parameter", "constant", "iota", "bitcast", "bitcast-convert", "reshape",
    "broadcast", "get-tuple-element", "tuple", "after-all", "partition-id",
    "replica-id", "domain", "opt-barrier", "while", "call", "conditional",
    "custom-call", "rng-get-and-update-state", "get-dimension-size",
    "add-dependency", "token",
})
_HLO_MOVE_OPS = frozenset({
    "slice", "dynamic-slice", "dynamic-update-slice", "concatenate", "pad",
    "gather", "transpose", "reverse", "copy", "copy-start", "copy-done",
    "send", "recv", "send-done", "recv-done", "infeed", "outfeed",
})
_HLO_REDUCE_OPS = frozenset({"reduce", "reduce-window", "scatter", "sort", "select-and-scatter"})


def hlo_op_cost(op: Any, *, inner_flops: float = 0.0) -> Optional[OpCost]:
    """Static cost of one device op by the JAX package's HLO-op rules
    (thunder_tpu/analysis/cost.py:731-777), for the ops the auditor
    (``analysis/hlo_audit.py``) cannot price by the trace line they ran in:
    a memcpy or memset node, an aten op outside every line whose shapes the
    profiler recorded, a collective launched outside the trace.

    ``op`` is duck-typed as the JAX package's: ``opcode``, ``result_bytes``/
    ``result_numel``, ``operand_bytes``/``operand_numel``, ``group_size``,
    ``k_dim`` (a product's contraction size), ``family`` (a collective's,
    else None). ``inner_flops`` is a fused launch's arithmetic, charged with
    its boundary bytes. None for a ``-done`` half (its ``-start`` carries the
    cost) and for free ops."""
    opcode = op.opcode
    fam = getattr(op, "family", None) or (
        opcode[:-6] if opcode.endswith("-start") and opcode[:-6] in HLO_COLLECTIVE_FACTORS
        else opcode if opcode in HLO_COLLECTIVE_FACTORS else None
    )
    if fam is not None:
        if opcode.endswith("-done"):
            return None
        # (g-1)/g of the full tensor: a gather's output, a native
        # reduce-scatter's input; an all-reduce's in and out are both full.
        full = op.operand_bytes if opcode.startswith("reduce-scatter") else op.result_bytes
        return OpCost(comm_bytes=hlo_collective_wire_bytes(fam, full, max(1, int(op.group_size))),
                      kind="collective")
    io = op.operand_bytes + op.result_bytes
    if opcode == "fusion":
        return OpCost(flops=inner_flops, bytes_moved=io, kind="fusion")
    if opcode in ("dot", "convolution"):
        return OpCost(flops=2.0 * op.result_numel * max(1.0, op.k_dim), bytes_moved=io, kind="matmul")
    if opcode in _HLO_FREE_OPS:
        return None
    if opcode in _HLO_MOVE_OPS:
        return OpCost(bytes_moved=io, kind="layout" if opcode.startswith("copy") else "shape")
    if opcode in _HLO_REDUCE_OPS:
        return OpCost(flops=op.operand_numel, bytes_moved=io, kind="reduction")
    return OpCost(flops=op.result_numel, bytes_moved=io, kind="elementwise")
