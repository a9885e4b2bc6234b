"""Attention-residual saving: the flash backward without a forward recompute.

Reference parity: thunder/executors/cudnnex.py:375 — the cuDNN SDPA
executor's backward graph consumes the forward's saved softmax_stats
(logsumexp) and output instead of re-running the forward. The counterpart of
``thunder_tpu/transforms/attention_residuals.py``. Autodiff emits a
``torch.sdpa_bwd`` composite, whose backward would recompute the scores'
softmax from scratch.

This pass rewrites matched (sdpa fwd, sdpa_bwd) pairs into
``torch.sdpa_fwd_res`` (returns out + lse) / ``torch.sdpa_bwd_res``
(consumes q, k, v, out, lse) so the flash executor claims both sides
(``csrc/flash_attn.cu`` writes lse, ``csrc/flash_bwd.cu`` reads it). It only
fires when the flash executor is active and says both sides are claimable
(``flashex.residual_eligible``: the flash checker plus S == L, no mask,
D ≤ 256); otherwise the pair is left on the recompute path. The rewrite
depends on shapes and dtypes only, so CPU and CUDA tensors get the same
trace.
"""

from __future__ import annotations

import time

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.core.trace import TraceCtx, from_trace, tracectx, wrap_in_trace_provenance


def _flash_active(executors) -> bool:
    """The flash executor is listed, and the recovery driver has not
    quarantined its residual pair (``resilience/demotion.py``)."""
    from thunder_tpu_torch.resilience.demotion import is_quarantined

    if any(is_quarantined(sym, "flash") for sym in ("torch.sdpa_fwd_res", "torch.sdpa_bwd_res")):
        return False
    return any(getattr(e, "name", None) == "flash" for e in (executors or ()))


def _bound_sdpa(args, kwargs) -> dict:
    names = ("query", "key", "value", "attn_mask", "dropout_p", "is_causal", "scale", "enable_gqa")
    defaults = {"attn_mask": None, "dropout_p": 0.0, "is_causal": False, "scale": None, "enable_gqa": False}
    b = dict(zip(names, args))
    b.update(kwargs)
    for k, v in defaults.items():
        b.setdefault(k, v)
    return b


def _bound_bwd(args, kwargs) -> dict:
    names = ("g", "query", "key", "value", "attn_mask", "is_causal", "scale", "enable_gqa")
    defaults = {"attn_mask": None, "is_causal": False, "scale": None, "enable_gqa": False}
    b = dict(zip(names, args))
    b.update(kwargs)
    for k, v in defaults.items():
        b.setdefault(k, v)
    return b


def _match_pairs(fw_bsyms, bw_bsyms):
    """(fw_index, bw_index, fwd_bound, bwd_bound) for claimable pairs."""
    from thunder_tpu_torch.executors import flashex

    fwd_by_key = {}
    for i, bsym in enumerate(fw_bsyms):
        if bsym.sym.id == "torch.scaled_dot_product_attention":
            b = _bound_sdpa(bsym.args, bsym.kwargs)
            if b["attn_mask"] is not None:
                continue
            key = (b["query"].name, b["key"].name, b["value"].name)
            fwd_by_key[key] = (i, b)

    pairs = []
    for j, bsym in enumerate(bw_bsyms):
        if bsym.sym.id != "torch.sdpa_bwd":
            continue
        b = _bound_bwd(bsym.args, bsym.kwargs)
        if b["attn_mask"] is not None:
            continue
        key = (b["query"].name, b["key"].name, b["value"].name)
        hit = fwd_by_key.get(key)
        if hit is None:
            continue
        i, fb = hit
        if not flashex.residual_eligible(fb["query"], fb["key"], fb["value"], enable_gqa=fb["enable_gqa"]):
            continue
        pairs.append((i, j, fb, b))
    return pairs


def _rewrite(trc: TraceCtx, idx: int, bound: dict, out_proxy) -> TensorProxy:
    """Swap bsym #idx for sdpa_fwd_res with output (out, lse); returns lse."""
    import thunder_tpu_torch.torch as ltorch

    q = bound["query"]
    B, H, Tq = q.shape[0], q.shape[-3], q.shape[-2]
    with tracectx(trc):
        lse = TensorProxy(shape=(B, H, Tq), dtype=dtypes.float32, device=q.device)
    new_bsym = ltorch.sdpa_fwd_res._symbol.bind(
        bound["query"], bound["key"], bound["value"], None,
        bound["is_causal"], bound["scale"], bound["enable_gqa"],
        output=(out_proxy, lse),
    )
    trc.bound_symbols[idx] = new_bsym
    return lse


def _rewrite_bwd(bw_bsyms, j: int, bound: dict, out_proxy, lse) -> None:
    import thunder_tpu_torch.torch as ltorch

    old = bw_bsyms[j]
    new_bsym = ltorch.sdpa_bwd_res._symbol.bind(
        bound["g"], bound["query"], bound["key"], bound["value"], out_proxy, lse,
        None, bound["is_causal"], bound["scale"], bound["enable_gqa"],
        output=old.output,
    )
    bw_bsyms[j] = new_bsym


def save_sdpa_residuals_joint(trc: TraceCtx, executors) -> TraceCtx:
    """Joint-trace variant (grad/value_and_grad pipelines): forward and
    backward composites live in ONE trace, so no saved-for-backward
    bookkeeping is needed."""
    if not _flash_active(executors):
        return trc
    pairs = _match_pairs(trc.bound_symbols, trc.bound_symbols)
    if not pairs:
        return trc
    start = time.perf_counter_ns()
    out_of = {}
    for i, _, fb, _bb in pairs:
        out_of[i] = trc.bound_symbols[i].output
    for i, j, fb, bb in pairs:
        lse = _rewrite(trc, i, fb, out_of[i])
        _rewrite_bwd(trc.bound_symbols, j, bb, out_of[i], lse)
    return wrap_in_trace_provenance(trc, "Attention residual saving (joint)", start)


def save_sdpa_residuals(fw_trace: TraceCtx, bw_trace: TraceCtx, executors):
    """Split-pipeline variant: rewrites the pair across the fw/bw traces and
    extends the saved-for-backward set with (out, lse). Run BEFORE
    rematerialization so the remat cost model accounts for the new saved
    bytes."""
    if not _flash_active(executors):
        return fw_trace, bw_trace
    saved_names = list(fw_trace.tags.get("saved_for_backward", []))
    if not saved_names:
        return fw_trace, bw_trace
    pairs = _match_pairs(fw_trace.bound_symbols, bw_trace.bound_symbols)
    if not pairs:
        return fw_trace, bw_trace
    start = time.perf_counter_ns()

    new_saved_proxies = []
    for i, j, fb, bb in pairs:
        out_proxy = fw_trace.bound_symbols[i].output
        lse = _rewrite(fw_trace, i, fb, out_proxy)
        _rewrite_bwd(bw_trace.bound_symbols, j, bb, out_proxy, lse)
        for p in (out_proxy, lse):
            if p.name not in saved_names:
                saved_names.append(p.name)
                new_saved_proxies.append(p)

    if not new_saved_proxies:
        return fw_trace, bw_trace

    from thunder_tpu_torch.core import prims

    # rebuild fw with the extended saved tuple
    primal_out, old_saved = fw_trace.output
    new_saved_tuple = tuple(old_saved) + tuple(new_saved_proxies)
    new_fw = from_trace(fw_trace)
    new_fw.bound_symbols.extend(
        b for b in fw_trace.bound_symbols if b.sym.id is not prims.PrimIDs.RETURN
    )
    new_out = (primal_out, new_saved_tuple)
    with tracectx(new_fw):
        prims.python_return(new_out)
    new_fw.output = new_out
    new_fw.tags["saved_for_backward"] = saved_names

    # rebuild bw with the extended arg list (saved... + cotangents...)
    n_old_saved = len(old_saved)
    cotangents = list(bw_trace.args[n_old_saved:])
    new_bw = from_trace(bw_trace)
    new_bw.args = tuple(old_saved) + tuple(new_saved_proxies) + tuple(cotangents)
    new_bw.bound_symbols.extend(bw_trace.bound_symbols)

    new_fw = wrap_in_trace_provenance(new_fw, "Attention residual saving (fw)", start)
    new_bw = wrap_in_trace_provenance(new_bw, "Attention residual saving (bw)", start)
    return new_fw, new_bw
