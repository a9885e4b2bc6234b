#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``thunder_tpu_torch`` only (no JAX, nothing of ``thunder_tpu``):

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds the CUDA kernels from ``thunder_tpu_torch/csrc`` for sm_90a and
   prints the build seconds and ptxas' register/spill lines;
3. runs each kernel at the shapes open_llama_3b's loss (B=2), forward (B=10)
   and training step (B=2) give it, holds it against its plain PyTorch
   version on the same inputs row by row, and times kernel, plain version
   and the nearest single PyTorch call (CUDA events);
4. checks the whole path at open_llama_3b's full width with 2 layers, forward
   at B=10, loss and gradients (``value_and_grad``) at B=2: the default
   executors against the torch executor alone, then the same with a planted
   attention fault in the forward and one in the backward, which must fail;
5. runs the full 26-layer open_llama_3b: ``jit(loss_fn)`` at B=2, T=2048 and
   ``jit(forward)`` at B=10, T=2048, with random weights from a seed, and
   checks that each kernel was launched the expected number of times;
6. builds the 26-layer training step (``benchmarks/train.py``) at B=2,
   T=2048 and runs 3 steps: prints the build seconds of each pass, the step
   seconds, the peak device memory and the loss, checks the launches of each
   kernel against the claimed traces and one param's in-place SGD update;
7. prints one JSON line describing every kernel, then the device line.

Any failed check raises, and the script exits non-zero without printing the
last line. Exits non-zero at once when there is no CUDA card.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from dataclasses import replace

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

CFG_NAME = "open_llama_3b"
SEQ = 2048
LOSS_BATCH = 2
FWD_BATCH = 10
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _library_ms(*calls):
    """The time of the first of ``calls`` that runs: a yardstick only, so a
    library call that refuses these shapes gives None, not a failure."""
    for call in calls:
        try:
            call()
        except RuntimeError:
            continue
        return time_ms(call, 20)
    return None


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# Phase 3: each kernel against its plain version at the path shapes
# =============================================================================


def row_rel_err(got, want, floor: float = 0.0) -> float:
    """The largest error in a row over that row's largest |value|, maximised
    over rows (a row is the last dim). A row that is wrong in part shows up
    in full, however small its values are next to other rows'. ``floor``
    (a fraction of the tensor's largest |value|) is the least reference a
    row gets."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    ref = want.abs().amax(-1).clamp_min(max(floor * want.abs().max().item(), torch.finfo(torch.float32).tiny))
    return (err / ref).max().item()


# Rope: f32 arithmetic rounded once to bf16 in both kernel and plain version;
# a fused multiply-add may move the rounding by one bf16 ulp of the element,
# which is at most 2^-7 of the row's largest |value|.
ROPE_ROW_REL = 2.0 ** -7
# Flash: both round O to bf16 once (up to one ulp, <= 2^-7 of the row max),
# and round P to bf16 against different maxima (the running max in the
# kernel, the row max in the plain version: relative 2^-9 per term of the
# weighted mean). Two ulps of the row max bound both together.
FLASH_ROW_REL = 2.0 ** -6
# Flash backward: P and dS are rounded to bf16 at the same places in kernel
# and plain version, from f32 values that differ in the last bits (exp2 of
# log2-scaled scores against exp), so a few terms round one ulp apart; with
# the outputs' own rounding, four ulps of the row max bound the difference.
# A row whose exact gradient is zero (query 0 sees only key 0, where dS
# cancels) holds only f32 noise, so each row's reference is at least eps^2 of
# the tensor's largest |value|.
FLASH_BWD_ROW_REL = 2.0 ** -5
# lse: an f32 logsumexp of up to 2048 terms, in base 2 in the kernel.
LSE_REL = 1e-5
# Cross-entropy backward: both compute (softmax - onehot) * scale in f32 and
# differ in summation order and exp's last bits: 1e-5 of the row's largest
# |value| (the target's entry).
CE_BWD_ROW_REL = 1e-5


def _path_inputs(cfg, batch: int, gen):
    """q/k/v as the path gives them to rope (views of the fused qkv
    projection) and rope's bf16 cos/sin tables."""
    import torch

    dev = torch.device("cuda")
    T, H, G, D = SEQ, cfg.n_head, cfg.query_groups, cfg.head_size
    qkv = torch.randn((batch, T, (H + 2 * G) * D), generator=gen, device=dev).to(torch.bfloat16)

    def heads(lo, n):
        return qkv[..., lo * D:(lo + n) * D].reshape(batch, T, n, D).permute(0, 2, 1, 3)

    pos = torch.arange(T, device=dev, dtype=torch.float32)[:, None]
    theta = cfg.rope_base ** (torch.arange(D // 2, device=dev, dtype=torch.float32) * -2.0 / D)
    emb = torch.cat([pos * theta, pos * theta], dim=1)
    return heads(0, H), heads(H, G), heads(H + G, G), emb.cos().to(torch.bfloat16), emb.sin().to(torch.bfloat16)


def check_kernels(cfg) -> list[dict]:
    """Rope and flash at both path batches (loss B=2, forward B=10), CE at the
    loss path's (B*T, V), and the training step's kernels (flash forward with
    logsumexp, flash backward, rope with -sin, CE backward) at B=2. Each is
    held against its plain version on the same inputs and timed; the
    returned rows are the B=2 timings with the largest error over both
    batches."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows: dict[str, dict] = {}

    def record(name, batch, err, rel, limit, **timing):
        row = rows.setdefault(name, dict(name=name, route="cuda", max_abs_err=0.0, row_rel_err=0.0,
                                         row_rel_limit=limit))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        t = timing
        log(f"  {name:8s} B={batch:<2d} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e}) "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at B={batch} ({rel} > {limit})")
        if batch == LOSS_BATCH:
            row.update(timing)

    for B in (LOSS_BATCH, FWD_BATCH):
        q_view, k_view, v_view, cos, sin = _path_inputs(cfg, B, gen)

        # -- rope: x (B, H, T, D) bf16, a strided view of qkv ------------------
        got = fusedex.apply_rope(q_view, cos, sin)
        want = fusedex.rope_plain(q_view, cos, sin)
        err = (got.float() - want.float()).abs().max().item()
        nb = q_view.numel() * 2 * 2 + cos.numel() * 2 * 2
        b_ms, b_by = bound(nb, 3.0 * q_view.numel(), PEAK_F32_FLOPS)
        record("rope", B, err, row_rel_err(got, want), ROPE_ROW_REL,
               source="thunder_tpu_torch/csrc/rope.cu", replaces="thunder_tpu/executors/pallasex.py:220",
               ms=time_ms(lambda: fusedex.apply_rope(q_view, cos, sin), 50),
               plain_ms=time_ms(lambda: fusedex.rope_plain(q_view, cos, sin), 20),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del got, want

        # -- flash: q, k rope outputs (contiguous), v a strided view -------------
        q = fusedex.apply_rope(q_view, cos, sin)
        k = fusedex.apply_rope(k_view, cos, sin)
        v = v_view
        scale = 1.0 / math.sqrt(cfg.head_size)
        got = flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)
        want = flashex.flash_attention_plain(q, k, v, causal=True, scale=scale)
        require(bool(torch.isfinite(got).all()), f"flash kernel produced non-finite values at B={B}")
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        del want
        pairs = SEQ * (SEQ + 1) // 2  # causal (query, key) pairs with Tq == Tkv
        flops = 4.0 * B * cfg.n_head * cfg.head_size * pairs
        nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
        b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
        record("flash_fwd", B, err, rel, FLASH_ROW_REL,
               source="thunder_tpu_torch/csrc/flash_attn.cu", replaces="thunder_tpu/executors/flashex.py:243",
               ms=time_ms(lambda: flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale), 20),
               plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale), 3, 1),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
        del got, q, k, v, q_view, k_view, v_view
        torch.cuda.empty_cache()

    # -- cross-entropy: logits (B*T, V) f32, int64 targets, some ignored -------
    N, V = LOSS_BATCH * SEQ, cfg.padded_vocab_size
    logits = torch.randn((N, V), generator=gen, device="cuda")
    targets = torch.randint(0, V, (N,), generator=gen, device="cuda")
    targets[::97] = -100
    got = fusedex.cross_entropy_rows(logits, targets, -100)
    want = fusedex.cross_entropy_rows_plain(logits, targets, -100)
    err = (got - want).abs().max().item()
    # Per-row losses near 10.9: an f32 logsumexp of 32000 terms summed in
    # another order differs by a few f32 ulps of the loss; 1e-5 relative.
    nb = logits.numel() * 4 + targets.numel() * 8 + N * 4
    b_ms, b_by = bound(nb, 4.0 * N * V, PEAK_F32_FLOPS)
    record("ce_fwd", LOSS_BATCH, err, row_rel_err(got[:, None], want[:, None]), 1e-5,
           source="thunder_tpu_torch/csrc/cross_entropy.cu", replaces="thunder_tpu/executors/pallasex.py:85",
           ms=time_ms(lambda: fusedex.cross_entropy_rows(logits, targets, -100), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_rows_plain(logits, targets, -100), 10),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: F.cross_entropy(logits, targets, ignore_index=-100, reduction="none"), 20))
    del got, want

    # -- the training step's kernels, at B=2 -----------------------------------
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    pairs = SEQ * (SEQ + 1) // 2

    # flash forward with logsumexp (A): q, k contiguous, v a strided view.
    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale)
    lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    require(lse_rel <= LSE_REL, f"flash_fwd_lse: lse differs from the plain version ({lse_rel} > {LSE_REL})")
    log(f"  flash_fwd_lse lse rel_err={lse_rel:.3e} (limit {LSE_REL:.0e})")
    nb = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_fwd_lse", B, (out.float() - want_out.float()).abs().max().item(), row_rel_err(out, want_out),
           FLASH_ROW_REL, source="thunder_tpu_torch/csrc/flash_attn.cu",
           replaces="thunder_tpu/executors/flashex.py:526",
           ms=time_ms(lambda: flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=_library_ms(
               lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q, k, v, None, True, 0.0, True,
                                                                               scale=scale),
               lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False, scale=scale)))
    del want_out, want_lse

    # flash backward (B): dout strided as the backward of the head transpose
    # gives it; (out, lse) from the kernel.
    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    require(all(bool(torch.isfinite(g).all()) for g in got), "flash_bwd produced non-finite values")
    eps = 2.0 ** -7
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
    del want
    flops = 10.0 * B * H * D * pairs
    # Read q, k, v, out, dout and lse once; write dq, dk, dv once.
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, flops, PEAK_BF16_FLOPS)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    record("flash_bwd", B, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
           replaces="thunder_tpu/executors/flashex.py:555",
           ms=time_ms(lambda: flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True,
                                                                      scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), dout, retain_graph=True), 10))
    dq = got[0]
    del ref, qr, kr, vr, got, out, lse, dout, v

    # rope backward (D): the rope kernel on dq (contiguous) with -sin.
    msin = -sin
    got = fusedex.apply_rope(dq, cos, msin)
    want = fusedex.rope_plain(dq, cos, msin)
    nb = dq.numel() * 2 * 2 + cos.numel() * 2 * 2
    b_ms, b_by = bound(nb, 3.0 * dq.numel(), PEAK_F32_FLOPS)
    record("rope_bwd", B, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want), ROPE_ROW_REL,
           source="thunder_tpu_torch/csrc/rope.cu", replaces="thunder_tpu/torch/__init__.py:1579",
           ms=time_ms(lambda: fusedex.apply_rope(dq, cos, msin), 50),
           plain_ms=time_ms(lambda: fusedex.rope_plain(dq, cos, msin), 20),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del got, want, dq, q, k
    torch.cuda.empty_cache()

    # cross-entropy backward (C): the loss path's logits, g = 1, mean.
    g = torch.ones((), device="cuda")
    row_scale = fusedex.ce_row_scale(g, targets, -100, "mean")
    got = fusedex.cross_entropy_bwd(logits, targets, row_scale)
    want = fusedex.cross_entropy_bwd_plain(logits, targets, row_scale)
    require(bool((got[::97] == 0).all()), "ce_bwd: an ignored row is not zero")
    nb = logits.numel() * 4 * 2 + targets.numel() * 8 + N * 4
    b_ms, b_by = bound(nb, 5.0 * N * V, PEAK_F32_FLOPS)
    lr_ = logits.detach().clone().requires_grad_()
    ref = F.cross_entropy(lr_, targets, ignore_index=-100)
    record("ce_bwd", B, (got - want).abs().max().item(), row_rel_err(got, want), CE_BWD_ROW_REL,
           source="thunder_tpu_torch/csrc/cross_entropy.cu", replaces="thunder_tpu/executors/pallasex.py:102",
           ms=time_ms(lambda: fusedex.cross_entropy_bwd(logits, targets, row_scale), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_bwd_plain(logits, targets, row_scale), 10),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: torch.autograd.grad(ref, lr_, retain_graph=True), 20))
    del got, want, ref, lr_, logits
    torch.cuda.empty_cache()
    return list(rows.values())


# =============================================================================
# Phases 4 and 5: the whole path
# =============================================================================


def _wrappers() -> dict:
    """Each kernel's wrapper by row name. The rope backward is the rope
    kernel's wrapper: its launches are those made during a backward."""
    from thunder_tpu_torch.executors import flashex, fusedex

    return {"flash_fwd": flashex.flash_attention_fwd, "rope": fusedex.apply_rope,
            "ce_fwd": fusedex.cross_entropy_rows, "flash_fwd_lse": flashex.flash_attention_fwd_lse,
            "flash_bwd": flashex.flash_attention_bwd, "ce_bwd": fusedex.cross_entropy_bwd}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


# The 2-layer model against the torch executor alone. The decomposition
# rounds q*scale and the scores to bf16 where the kernel keeps scores in f32,
# so logits differ by a few bf16 ulps; the limits are set from a sound run's
# readings (PERF.md) and a planted fault (attention without its causal mask)
# must exceed them, which shows that the comparison can see attention.
LOGITS_ROW_REL = 2.0 ** -4
LOSS_REL = 1e-4
# Gradients of the 2-layer loss, each param's held by its norm-relative
# error against the torch executor's (whose decomposed attention backward
# rounds its scores and probabilities to bf16 where the kernels keep f32);
# set from a sound run's reading (worst 2.58e-2, PERF.md), and a planted
# fault (the flash backward without its causal mask) must exceed it.
GRAD_REL = 2.0 ** -4


def check_two_layers(cfg) -> None:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex
    from thunder_tpu_torch.models import gpt

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = gpt.init_params(cfg2, seed=SEED, device="cuda")
    rng = np.random.RandomState(SEED)
    idx_fwd = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (FWD_BATCH, SEQ))).cuda()
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()

    def run(executors):
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg2), executors=executors)
        loss = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        out = fwd(params, idx_fwd).float(), float(loss(params, idx, tgt))
        torch.cuda.synchronize()
        return out

    want_logits, want_loss = run(["torch"])

    def compare(label, logits, loss) -> bool:
        rel = row_rel_err(logits, want_logits)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        ok = math.isfinite(loss) and rel <= LOGITS_ROW_REL and loss_rel <= LOSS_REL
        log(f"  2-layer {label}: logits B={FWD_BATCH} max_abs_err={(logits - want_logits).abs().max().item():.3e} "
            f"row_rel_err={rel:.3e} (limit {LOGITS_ROW_REL:.3e}); loss B={LOSS_BATCH} {loss:.6f} vs torch "
            f"{want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}) -> {'pass' if ok else 'FAIL'}")
        return ok

    sound = compare("kernels", *run(None))
    real = flashex.flash_attention_fwd

    def planted(q, k, v, *, causal, scale):
        return real(q, k, v, causal=False, scale=scale)

    planted.launches = 0  # the kernel counts its launches on the module's name
    flashex.flash_attention_fwd = planted
    try:
        planted = compare("planted fault (flash without its causal mask)", *run(None))
    finally:
        flashex.flash_attention_fwd = real
    require(sound, "2-layer model with the kernels differs from the torch executor")
    require(not planted, "the 2-layer comparison did not see a planted attention fault")
    del want_logits

    # Gradients at B=2: value_and_grad with the default executors (flash
    # forward with lse and backward, CE backward, rope both ways) against the
    # torch executor alone.
    import torch.utils._pytree as pytree

    names = [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]

    def grads(executors):
        f = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        loss, g = f(params, idx, tgt)
        out = float(loss), [x.float() for x in g]
        torch.cuda.synchronize()
        return out

    want_gloss, want_grads = grads(["torch"])

    def compare_grads(label, loss, got) -> bool:
        rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(got, want_grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        ok = math.isfinite(loss) and all(math.isfinite(r) for r in rels) and rels[worst] <= GRAD_REL
        log(f"  2-layer grads {label}: loss {loss:.6f} vs torch {want_gloss:.6f}; worst norm-relative error "
            f"{rels[worst]:.3e} on {names[worst]} (limit {GRAD_REL:.3e}); median {sorted(rels)[len(rels) // 2]:.3e} "
            f"-> {'pass' if ok else 'FAIL'}")
        return ok

    sound = compare_grads("kernels", *grads(None))
    real_bwd = flashex.flash_attention_bwd

    def planted_bwd(dout, q, k, v, out, lse, *, causal, scale):
        return real_bwd(dout, q, k, v, out, lse, causal=False, scale=scale)

    planted_bwd.launches = 0
    flashex.flash_attention_bwd = planted_bwd
    try:
        planted = compare_grads("planted fault (flash backward without its causal mask)", *grads(None))
    finally:
        flashex.flash_attention_bwd = real_bwd
    require(sound, "2-layer gradients with the kernels differ from the torch executor's")
    require(not planted, "the 2-layer gradient comparison did not see a planted attention-backward fault")
    del params, want_grads


def run_full(cfg) -> dict:
    import numpy as np
    import torch

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.models import gpt

    # The jitted functions of phase 4 hold their inputs in reference cycles;
    # collect them so the peaks below are the full model's alone.
    gc.collect()
    log(f"  allocated before the full model: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_params: {time.perf_counter() - t0:.2f} s")
    rng = np.random.RandomState(SEED)
    launches = {k: 0 for k in _launch_counts()}

    def drive(label, fn, args, per_call, calls=3):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _launch_counts()
        log(f"  {label}: first call (trace + run) {times[0]:.3f} s, then "
            f"{', '.join(f'{x:.4f}' for x in times[1:])} s/call; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        for k, n in per_call.items():
            require(counts[k] == n * calls, f"{label}: {k} launched {counts[k]} times, expected {n * calls}")
        for k in launches:
            launches[k] += counts[k]
        return out

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    loss_fn = tt.jit(lambda p, i, t: gpt.loss_fn(p, i, t, cfg))
    n = cfg.n_layer
    none = {"flash_fwd_lse": 0, "flash_bwd": 0, "ce_bwd": 0}
    loss = float(drive(f"loss B={LOSS_BATCH} T={SEQ}", loss_fn, (params, idx, tgt),
                       {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 1, **none}))
    # Random init: logits ~ N(0, s^2) with s = 0.02 * sqrt(n_embd) ~ 1.13, so
    # the loss is about ln V + s^2 / 2 ~ 11.0.
    log(f"  loss = {loss:.6f} (ln V = {math.log(cfg.vocab_size):.4f})")
    require(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 2.0, "loss is not near ln V")
    del loss_fn

    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (FWD_BATCH, SEQ))).cuda()
    fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg))
    logits = drive(f"forward B={FWD_BATCH} T={SEQ}", fwd, (params, idx),
                   {"flash_fwd": n, "rope": 2 * n, "ce_fwd": 0, **none})
    require(tuple(logits.shape) == (FWD_BATCH, SEQ, cfg.padded_vocab_size), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), "forward logits are not finite")
    return launches


# =============================================================================
# Phase 6: the training step
# =============================================================================

TRAIN_STEPS = 3


def run_train(cfg, launches: dict) -> None:
    """``build_train`` on the full model at B=2, T=2048, then 3 steps. Each
    step is driven through its parts (forward, backward, SGD), with the
    launch counts zeroed before and read after the forward and the backward,
    so the rope's forward and backward launches are told apart."""
    import torch

    from thunder_tpu_torch.benchmarks import train

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = train.build_train(cfg, LOSS_BATCH, SEQ, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    passes = ", ".join(f"{k} {v:.3f} s" for k, v in tr.seconds.items())
    log(f"  build_train: {build_s:.3f} s with init_params; passes (first call): {passes}")
    fw_src, bw_src = tr.fw_trace.python(), tr.bw_trace.python()
    n = cfg.n_layer
    per_fw = {"flash_fwd_lse": fw_src.count("flash_sdpa_fwd_res("), "rope": fw_src.count("fused_apply_rope("),
              "ce_fwd": fw_src.count("fused_cross_entropy(")}
    per_bw = {"flash_bwd": bw_src.count("flash_sdpa_bwd_res("), "rope_bwd": bw_src.count("fused_apply_rope("),
              "ce_bwd": bw_src.count("fused_cross_entropy_bwd(")}
    params_in = {a.name for a in tr.fw_trace.args}
    saved = [p for p in tr.fw_trace.output[1] if p.name not in params_in]
    log(f"  claimed per step: forward {per_fw}, backward {per_bw}; saved for backward "
        f"{len(tr.fw_trace.output[1])} tensors, {len(saved)} of them not params, holding "
        f"{sum(p.size_bytes for p in saved) / 1e9:.2f} GB by the trace's shapes")
    require(per_fw == {"flash_fwd_lse": n, "rope": 2 * n, "ce_fwd": 1}
            and per_bw == {"flash_bwd": n, "rope_bwd": 2 * n, "ce_bwd": 1},
            "the training traces do not claim every attention, rope and cross-entropy op")

    weights = torch.cuda.memory_allocated()
    log(f"  allocated with the weights: {weights / 2**30:.2f} GiB")
    probe = tr.params["lm_head_w"]
    probe_i = next(i for i, p in enumerate(tr.flat_params) if p is probe)
    times, losses = [], []
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()  # steps 2.. hold no probe copies
        t = time.perf_counter()
        _zero_counts()
        loss, saved = tr.forward()
        fw_counts = _launch_counts()
        if step == 0:
            torch.cuda.synchronize()
            log(f"  after the forward: {(torch.cuda.memory_allocated() - weights) / 2**30:.2f} GiB above the weights "
                f"({len(saved)} saved tensors)")
        _zero_counts()
        grads = tr.backward(loss, saved)
        bw_counts = _launch_counts()
        if step == 0:
            p0, g0, ptr = probe.detach().clone(), grads[probe_i].clone(), probe.data_ptr()
        tr.sgd_(grads)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        got = {"flash_fwd_lse": fw_counts["flash_fwd_lse"], "rope": fw_counts["rope"], "ce_fwd": fw_counts["ce_fwd"],
               "flash_bwd": bw_counts["flash_bwd"], "rope_bwd": bw_counts["rope"], "ce_bwd": bw_counts["ce_bwd"]}
        require(got == {**per_fw, **per_bw}, f"train step {step + 1}: launches {got}, the traces claim "
                                             f"{ {**per_fw, **per_bw} }")
        require(fw_counts["flash_fwd"] == 0 and bw_counts["flash_fwd"] == 0, "the train step ran the plain flash "
                "forward instead of the one with logsumexp")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if step == 0:
            # SGD in place, bf16-true: the same four roundings, recomputed.
            upd = torch.mul(p0, train.WD)
            upd = torch.add(g0, upd)
            upd.mul_(train.LR)
            want = p0 - upd
            moved = (probe != p0).float().mean().item()
            log(f"  step 1 SGD on lm_head_w: in place {probe.data_ptr() == ptr}, equal to the recomputed update "
                f"{torch.equal(probe, want)}, {moved:.4%} of its bf16 values moved (|lr*g| is mostly below an ulp)")
            require(probe.data_ptr() == ptr and torch.equal(probe, want), "the SGD update of lm_head_w is wrong")
            require(moved > 0, "the SGD step moved no value of lm_head_w")
            del p0, g0, upd, want
    peak = torch.cuda.max_memory_allocated()
    log(f"  train B={LOSS_BATCH} T={SEQ}: step 1 {times[0]:.4f} s, then {', '.join(f'{x:.4f}' for x in times[1:])} "
        f"s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) = {peak / 2**30:.2f} GiB; "
        f"loss {', '.join(f'{x:.6f}' for x in losses)}; launches per step {got}")
    require(all(math.isfinite(x) and abs(x - math.log(cfg.vocab_size)) < 2.0 for x in losses),
            "training loss is not near ln V")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from thunder_tpu_torch.executors import _build
    from thunder_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt.name_to_config(CFG_NAME)

    log("[1] card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)  # name, power limit: every time below was taken at this limit
    log(f"  torch: {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")

    log("[2] build")
    info = _build.build()
    _build.lib()
    log(f"  built {info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    log(f"[3] kernels at {CFG_NAME} path shapes")
    rows = check_kernels(cfg)

    log(f"[4] {CFG_NAME} at full width, 2 layers: default executors vs torch executor, forward and gradients")
    check_two_layers(cfg)

    log(f"[5] {CFG_NAME}, {cfg.n_layer} layers")
    launches = run_full(cfg)

    log(f"[6] {CFG_NAME}, {cfg.n_layer} layers: training step")
    run_train(cfg, launches)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "row_rel_err", "row_rel_limit",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys} for r in rows]
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
