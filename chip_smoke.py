#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It drives ``thunder_tpu_torch`` only (no JAX, nothing of ``thunder_tpu``):

1. prints the card (``nvidia-smi`` name and power limit, torch's name);
2. builds the CUDA kernels from ``thunder_tpu_torch/csrc`` for sm_90a and
   prints the build seconds and ptxas' register/spill lines;
3. runs each kernel at the shapes its paths give it: open_llama_3b's loss
   (B=2), forward (B=10) and training step (B=2); the norm executor's
   RMSNorm at open_llama_3b's (4096, 3200) and LayerNorm at pythia-410m's
   (4096, 1024); the training kernels at pythia-410m's shapes; the masked
   forward and recompute backward on the padded path's (2, 32, 2048, 100),
   with a planted fault (the padding ignored) that must fail; the legacy
   route's forward and backward (row 10) at the training path's. Each is
   held against its plain PyTorch version on the same inputs row by row and
   timed on the card beside its plain version and the nearest single
   PyTorch call (CUDA events);
4. checks the whole path at open_llama_3b's full width with 2 layers, forward
   at B=10, loss and gradients (``value_and_grad``) at B=2: the default
   executors against the torch executor alone, then the same with a planted
   attention fault in the forward and one in the backward, which must fail;
5. runs the full 26-layer open_llama_3b: ``jit(loss_fn)`` at B=2, T=2048 and
   ``jit(forward)`` at B=10, T=2048, with random weights from a seed, each
   staged as a CUDA graph (warm-up, capture, replay), and checks that each
   kernel was launched the expected number of times;
6. builds the 26-layer training step (``benchmarks/train.py``) at B=2,
   T=2048 and runs 3 unstaged steps: prints the build seconds of each pass,
   the step seconds, the peak device memory and the loss, checks the
   launches of each kernel against the claimed traces and one param's
   in-place SGD update; then puts the params back and runs 3 staged steps
   (``Train.step``, one CUDA graph) from the same state, launches checked
   per step, losses against the unstaged ones; each step is then timed and
   profiled, and s/step, enqueue ms, busy share and peak memory printed
   side by side;
7. checks pythia-410m at full width with 2 layers, forward and gradients at
   B=2: the norm executor's stack against the torch executor alone, then
   with a planted fault in the LayerNorm forward and one in its backward,
   which must fail;
8. runs the LitGPT benchmark (``benchmarks/litgpt.py``) on the full
   24-layer pythia-410m at B=2, T=2048 with AdamW, under the default stack
   and under ``+norm`` (2 warm-up and 5 timed steps each, staged: the
   warm-up is the eager first call and the capture): prints s/iter,
   tokens/s, MFU, peak memory and the loss, checks the launches of each
   kernel against the claimed trace, and one more step's AdamW update of a
   param against the formula; then the default stack's step unstaged and
   staged from the same state, side by side as in phase 6;
9. runs the LitGPT benchmark on open_llama_3b under ``+norm`` with SGD
   (2 warm-up and 3 timed steps), with the same checks;
10. checks ``thunder_tpu_torch.jit(module)`` on the Llama stand-in below
   (HF ``LlamaForCausalLM``'s names and SDPA-path arithmetic) at
   open_llama_3b's full width with 2 layers, on a batch whose row 0 is
   left-padded by 512 tokens: the default executors against the torch
   executor alone for the valid rows' logits, the loss and every gradient,
   then with the masked kernels ignoring the padding, which must fail; and
   an ALiBi-like bias, which must take the exact branch;
11. runs the stand-in at full depth (26 layers) on that padded batch: the
   forward without grad, the all-ones mask (the value guard's second
   entry), 3 ``torch.optim.SGD`` steps with a falling loss, launches checked
   against the claimed traces, and one profiled forward and step (the
   module frontend runs unstaged);
12. runs 3 staged open_llama_3b training steps under
   ``THUNDER_FLASH_IMPL=legacy``: the legacy route's launches (row 10)
   against the claimed traces, the losses against phase 6's splash route;
13. prints one JSON line describing every kernel, then the device line.

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
from dataclasses import dataclass, replace

import numpy as np
import torch
from torch import nn

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
    """The card's time for one call of ``fn``: the average over ``iters``
    calls launched back to back, between two CUDA events. A sleep kernel
    holds the card while the host enqueues the calls, so the host's time to
    launch them (Python, a wrapper's checks) does not show, as it would for
    a kernel of a few microseconds; if the card woke before the last call
    was queued, it sleeps twice as long and the calls are timed again."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sleep_s = 2 * (time.perf_counter() - t) + 1e-3
    torch.cuda.synchronize()
    for _ in range(4):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles; the H100's clock is below 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        hidden = not start.query()  # the card was still asleep when the last call was queued
        torch.cuda.synchronize()
        if hidden:
            return start.elapsed_time(stop) / iters
        sleep_s *= 2
    raise SystemExit("FAILED: time_ms could not hide the host's launches behind the card's sleep")


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


def _lse_library_calls(q, k, v, scale: float) -> tuple:
    """One PyTorch call each that computes causal attention and saves its
    logsumexp: the aten efficient and flash ops (which refuse some head
    sizes), then SDPA on inputs that require grad (which pads the head and
    saves the logsumexp for its backward)."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    return (
        lambda: torch.ops.aten._scaled_dot_product_efficient_attention(q, k, v, None, True, 0.0, True, scale=scale),
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True, False, scale=scale),
        lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale),
    )


def _sdpa_bwd_library_ms(q, k, v, dout, scale: float) -> float:
    """The time of SDPA's autograd backward: (dq, dk, dv) of causal attention
    from its saved forward."""
    import torch
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, scale=scale)
    return time_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), dout, retain_graph=True), 10)


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# =============================================================================
# The Llama stand-in: the module that phases 10-11 jit
# =============================================================================
#
# The machine with the card has no ``transformers``, so the nn.Module path
# runs on this plain-torch Llama. Its module and parameter names are those of
# HF's ``LlamaForCausalLM``, and it follows the arithmetic of transformers
# 4.57's SDPA path: rotate-half rope from ``inv_freq`` in f32, cast to the
# model's dtype; RMSNorm in f32, cast back, then scaled by the weight;
# SwiGLU; ``repeat_kv`` before SDPA when there is a mask, GQA in SDPA when
# there is none; and HF's mask: none (and ``is_causal``) when
# ``attention_mask.all()`` holds, else a bool (B, 1, T, T) causal∧padding
# mask. The CPU tests hold it against ``transformers.LlamaForCausalLM`` with
# the same state_dict. It is the smoke test's model, not a package feature.


@dataclass(frozen=True)
class LlamaConfig:
    """The fields of HF's LlamaConfig that the stand-in reads."""

    vocab_size: int = 32000
    hidden_size: int = 3200
    intermediate_size: int = 8640
    num_hidden_layers: int = 26
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# open_llama_3b (the JAX package's config, thunder_tpu/models/gpt.py:116-119)
OPEN_LLAMA_3B = LlamaConfig()


class LlamaRMSNorm(nn.Module):
    def __init__(self, hidden_size: int, eps: float, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, **factory))
        self.variance_epsilon = eps

    def forward(self, hidden_states):
        input_dtype = hidden_states.dtype
        hidden_states = hidden_states.to(torch.float32)
        variance = hidden_states.pow(2).mean(-1, keepdim=True)
        hidden_states = hidden_states * torch.rsqrt(variance + self.variance_epsilon)
        return self.weight * hidden_states.to(input_dtype)


class LlamaRotaryEmbedding(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        dim = config.head_dim
        inv_freq = 1.0 / (config.rope_theta ** (torch.arange(0, dim, 2, dtype=torch.int64, device=device).float() / dim))
        self.register_buffer("inv_freq", inv_freq, persistent=False)

    def forward(self, x, position_ids):
        inv_freq_expanded = self.inv_freq[None, :, None].float().expand(position_ids.shape[0], -1, 1)
        position_ids_expanded = position_ids[:, None, :].float()
        freqs = (inv_freq_expanded.float() @ position_ids_expanded.float()).transpose(1, 2)
        emb = torch.cat((freqs, freqs), dim=-1)
        return emb.cos().to(dtype=x.dtype), emb.sin().to(dtype=x.dtype)


def _rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _repeat_kv(hidden_states, n_rep: int):
    batch, num_key_value_heads, slen, head_dim = hidden_states.shape
    if n_rep == 1:
        return hidden_states
    hidden_states = hidden_states[:, :, None, :, :].expand(batch, num_key_value_heads, n_rep, slen, head_dim)
    return hidden_states.reshape(batch, num_key_value_heads * n_rep, slen, head_dim)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        hd, H, G = config.head_dim, config.num_attention_heads, config.num_key_value_heads
        self.head_dim = hd
        self.num_key_value_groups = H // G
        self.scaling = hd ** -0.5
        self.q_proj = nn.Linear(config.hidden_size, H * hd, bias=False, **factory)
        self.k_proj = nn.Linear(config.hidden_size, G * hd, bias=False, **factory)
        self.v_proj = nn.Linear(config.hidden_size, G * hd, bias=False, **factory)
        self.o_proj = nn.Linear(H * hd, config.hidden_size, bias=False, **factory)

    def forward(self, hidden_states, position_embeddings, attention_mask):
        input_shape = hidden_states.shape[:-1]
        hidden_shape = (*input_shape, -1, self.head_dim)
        query = self.q_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        key = self.k_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        value = self.v_proj(hidden_states).view(hidden_shape).transpose(1, 2)
        cos, sin = position_embeddings
        cos, sin = cos.unsqueeze(1), sin.unsqueeze(1)
        query = (query * cos) + (_rotate_half(query) * sin)
        key = (key * cos) + (_rotate_half(key) * sin)
        # transformers' sdpa_attention_forward: GQA inside SDPA without a
        # mask, repeat_kv with one; is_causal only without a mask.
        sdpa_kwargs = {}
        if attention_mask is None:
            sdpa_kwargs = {"enable_gqa": True}
        else:
            key = _repeat_kv(key, self.num_key_value_groups)
            value = _repeat_kv(value, self.num_key_value_groups)
            attention_mask = attention_mask[:, :, :, : key.shape[-2]]
        is_causal = query.shape[2] > 1 and attention_mask is None
        out = torch.nn.functional.scaled_dot_product_attention(
            query, key, value, attn_mask=attention_mask, dropout_p=0.0, scale=self.scaling, is_causal=is_causal,
            **sdpa_kwargs)
        out = out.transpose(1, 2).contiguous()
        out = out.reshape(*input_shape, -1).contiguous()
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.gate_proj = nn.Linear(config.hidden_size, config.intermediate_size, bias=False, **factory)
        self.up_proj = nn.Linear(config.hidden_size, config.intermediate_size, bias=False, **factory)
        self.down_proj = nn.Linear(config.intermediate_size, config.hidden_size, bias=False, **factory)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)

    def forward(self, hidden_states, attention_mask, position_embeddings):
        residual = hidden_states
        hidden_states = self.self_attn(self.input_layernorm(hidden_states), position_embeddings, attention_mask)
        hidden_states = residual + hidden_states
        residual = hidden_states
        return residual + self.mlp(self.post_attention_layernorm(hidden_states))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size, **factory)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **factory) for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, **factory)
        self.rotary_emb = LlamaRotaryEmbedding(config, device=factory.get("device"))

    @staticmethod
    def causal_mask(attention_mask, T: int):
        """HF's SDPA mask: None when every token is valid (the caller then
        runs causal SDPA), else a bool (B, 1, T, T) mask, query i seeing key
        j iff j <= i and key j is valid. ``attention_mask.all()`` is a
        branch on data: under the jit it becomes a value guard."""
        if attention_mask is None or attention_mask.all():
            return None
        idx = torch.arange(T, device=attention_mask.device)
        causal = idx[None, :] <= idx[:, None]
        return causal[None, None, :, :] & attention_mask.bool()[:, None, None, :]

    def forward(self, input_ids, attention_mask=None):
        hidden_states = self.embed_tokens(input_ids)
        T = input_ids.shape[1]
        position_ids = torch.arange(T, device=input_ids.device).unsqueeze(0)
        mask = self.causal_mask(attention_mask, T)
        position_embeddings = self.rotary_emb(hidden_states, position_ids)
        for layer in self.layers:
            hidden_states = layer(hidden_states, mask, position_embeddings)
        return self.norm(hidden_states)


class LlamaForCausalLM(nn.Module):
    """HF's module tree and forward: ``{"logits"}``, and ``{"loss"}`` when
    ``labels`` are given: cross-entropy of the f32 logits against labels
    already aligned with them (the next token; −100 where nothing is to be
    predicted, e.g. at pads), mean over the labelled positions."""

    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        factory = {"device": device, "dtype": dtype}
        self.config = config
        self.model = LlamaModel(config, **factory)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size, bias=False, **factory)

    def forward(self, input_ids, attention_mask=None, labels=None):
        logits = self.lm_head(self.model(input_ids, attention_mask))
        out = {"logits": logits}
        if labels is not None:
            V = logits.shape[-1]
            out["loss"] = torch.nn.functional.cross_entropy(logits.float().reshape(-1, V), labels.reshape(-1),
                                                            ignore_index=-100)
        return out


def llama(config: LlamaConfig, *, seed: int, device, dtype=torch.bfloat16) -> LlamaForCausalLM:
    """The stand-in with random weights from ``seed``: matrices and the
    embedding N(0, 0.02) (HF's initializer_range), norm weights 1, drawn on
    ``device`` in f32 and rounded to ``dtype``."""
    with torch.no_grad():
        m = LlamaForCausalLM(config, device=device, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, p in m.named_parameters():
            if not name.endswith("layernorm.weight") and name != "model.norm.weight":
                p.copy_(torch.empty(p.shape, device=device).normal_(0.0, 0.02, generator=gen))
    return m


def padded_batch(B: int, T: int, vocab: int, left_pad: dict, *, seed: int, device):
    """(input_ids, attention_mask, labels): token ids from ``seed``; batch row
    b left-padded by ``left_pad.get(b, 0)`` tokens (mask 0, id 0); labels the
    next token, −100 at the last position and wherever the query or the next
    token is a pad, so pad rows carry no weight."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, vocab, (B, T))).to(device)
    am = torch.ones((B, T), dtype=torch.int64, device=device)
    for b, n in left_pad.items():
        am[b, :n] = 0
        ids[b, :n] = 0
    labels = torch.full((B, T), -100, dtype=torch.int64, device=device)
    labels[:, :-1] = ids[:, 1:]
    labels[:, :-1][(am[:, :-1] == 0) | (am[:, 1:] == 0)] = -100
    return ids, am, labels


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


def _recorder(rows: dict):
    """``record(name, batch, err, rel, limit, **timing)``: log one check of a
    kernel and fold it into its row: the largest errors over every check,
    and the timing of the check at the loss path's batch (or, for a kernel
    first checked here, of its first check)."""

    def record(name, batch, err, rel, limit, **timing):
        new = name not in rows
        row = rows.setdefault(name, dict(name=name, route="cuda", max_abs_err=0.0, row_rel_err=0.0,
                                         row_rel_limit=limit))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        t = timing
        log(f"  {name:8s} {str(batch):>6s} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e}) "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at {batch} ({rel} > {limit})")
        if batch == LOSS_BATCH or new:
            row.update(timing)

    return record


def check_kernels(cfg, rows: dict) -> None:
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
    record = _recorder(rows)

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
           library_ms=_library_ms(*_lse_library_calls(q, k, v, scale)))
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
    record("flash_bwd", B, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
           replaces="thunder_tpu/executors/flashex.py:555",
           ms=time_ms(lambda: flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True,
                                                                      scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_sdpa_bwd_library_ms(q, k, v, dout, scale))
    dq = got[0]
    del got, out, lse, dout, v

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


# The norm kernels and their plain versions compute in f32 and round each
# output once: y and dx within one bf16 ulp (2^-7) of the row's largest
# |value|; dw and db are f32 sums over the rows in another order, 1e-5 of
# the vector's largest |value|. Set from bf16 rounding, before any reading.
NORM_ROW_REL = 2.0 ** -7
NORM_DW_REL = 1e-5


def check_norm_kernels(llama, pythia, rows: dict) -> None:
    """The norm executor's four kernels at their path shapes: RMSNorm on
    open_llama_3b's (B*T, 3200) bf16 rows with eps 1e-6, LayerNorm with
    bias on pythia-410m's (B*T, 1024) with eps 1e-5. Each is held against
    its plain version and timed beside ``F.rms_norm``/``F.layer_norm`` and
    their autograd backward."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import normex

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = _recorder(rows)
    N = LOSS_BATCH * SEQ
    for cfg, layer_norm in ((llama, False), (pythia, True)):
        D, eps = cfg.n_embd, cfg.norm_eps
        # A residual stream with a per-row offset and a weight and bias away
        # from their init, so that every term of the kernels shows.
        x = (torch.randn((N, D), generator=gen, device="cuda") * 2
             + torch.randn((N, 1), generator=gen, device="cuda")).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16)
        b = (0.1 * torch.randn((D,), generator=gen, device="cuda")).to(torch.bfloat16) if layer_norm else None
        g = torch.randn((N, D), generator=gen, device="cuda").to(torch.bfloat16)
        tag, shape = ("ln", f"{N}x{D}") if layer_norm else ("rms", f"{N}x{D}")
        src, repl = "thunder_tpu_torch/csrc/norm.cu", "thunder_tpu/executors/pallasex.py"
        nb = N * D * 2

        if layer_norm:
            fwd = lambda: normex.layer_norm_fwd(x, w, b, eps)  # noqa: E731
            bwd = lambda: normex.layer_norm_bwd(g, x, w, eps, with_bias=True)  # noqa: E731
            lib_fwd = lambda: F.layer_norm(x, (D,), w, b, eps)  # noqa: E731
            params = (w, b)
        else:
            fwd = lambda: normex.rms_norm_fwd(x, w, eps)  # noqa: E731
            bwd = lambda: normex.rms_norm_bwd(g, x, w, eps) + (None,)  # noqa: E731
            lib_fwd = lambda: F.rms_norm(x, (D,), w, eps)  # noqa: E731
            params = (w,)
        plain_fwd = lambda: normex.norm_fwd_plain(x, w, b, eps, layer_norm=layer_norm)  # noqa: E731
        plain_bwd = lambda: normex.norm_bwd_plain(g, x, w, eps, layer_norm=layer_norm,  # noqa: E731
                                                  with_bias=layer_norm)

        got, want = fwd(), plain_fwd()
        b_ms, b_by = bound(2 * nb + len(params) * D * 2, 6.0 * N * D, PEAK_F32_FLOPS)
        record(f"{tag}_fwd", shape, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want),
               NORM_ROW_REL, source=src, replaces=f"{repl}:{410 if layer_norm else 299}",
               ms=time_ms(fwd, 50), plain_ms=time_ms(plain_fwd, 10), bound_ms=b_ms, bound_by=b_by,
               library_ms=_library_ms(lib_fwd))
        del got, want

        (dx, dw, db), (want_dx, want_dw, want_db) = bwd(), plain_bwd()
        require(bool(torch.isfinite(dx).all()), f"{tag}_bwd produced non-finite values")
        vec_rel = max(((a - r).abs().max() / r.abs().max()).item()
                      for a, r in ((dw, want_dw), (db, want_db)) if r is not None)
        log(f"  {tag}_bwd dw{'/db' if layer_norm else ''} rel_err={vec_rel:.3e} (limit {NORM_DW_REL:.0e})")
        require(vec_rel <= NORM_DW_REL, f"{tag}_bwd: dw/db differ from the plain version ({vec_rel})")
        # Read g, x and w; write dx and the f32 dw (and db).
        b_ms, b_by = bound(3 * nb + D * 2 + len(params) * D * 4, 12.0 * N * D, PEAK_F32_FLOPS)
        xr = x.detach().clone().requires_grad_()
        pr = [p.detach().clone().requires_grad_() for p in params]
        ref = F.layer_norm(xr, (D,), pr[0], pr[1], eps) if layer_norm else F.rms_norm(xr, (D,), pr[0], eps)
        record(f"{tag}_bwd", shape, (dx.float() - want_dx.float()).abs().max().item(), row_rel_err(dx, want_dx),
               NORM_ROW_REL, source=src, replaces=f"{repl}:{424 if layer_norm else 309}",
               ms=time_ms(bwd, 50), plain_ms=time_ms(plain_bwd, 10), bound_ms=b_ms, bound_by=b_by,
               library_ms=_library_ms(lambda: torch.autograd.grad(ref, [xr, *pr], g, retain_graph=True)))
        del dx, dw, db, want_dx, want_dw, want_db, ref, xr, pr, x, g
        torch.cuda.empty_cache()


def check_pythia_shapes(cfg, rows: dict) -> None:
    """The training step's attention and cross-entropy kernels at
    pythia-410m's shapes (B=2): q/k/v (2, 16, 2048, 64), where q and k come
    contiguous from the decomposed partial rope and v is a strided view of
    the qkv projection, and logits (4096, 50304) f32. Held to the same
    limits as at open_llama_3b's shapes; the errors join the rows, the
    times are logged."""
    import torch

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    record = _recorder(rows)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    pairs = SEQ * (SEQ + 1) // 2
    q_view, k_view, v, _, _ = _path_inputs(cfg, B, gen)
    q, k = q_view.contiguous(), k_view.contiguous()
    del q_view, k_view
    shape = f"{B}x{H}x{SEQ}x{D}"

    out, lse = flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale)
    want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale)
    lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
    require(lse_rel <= LSE_REL, f"flash_fwd_lse at {shape}: lse differs from the plain version ({lse_rel})")
    nb = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_fwd_lse", shape, (out.float() - want_out.float()).abs().max().item(),
           row_rel_err(out, want_out), FLASH_ROW_REL,
           ms=time_ms(lambda: flashex.flash_attention_fwd_lse(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_lse_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_library_ms(*_lse_library_calls(q, k, v, scale)))
    del want_out, want_lse

    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    got = flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    eps = 2.0 ** -7
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) * 2 + lse.numel() * 4
    b_ms, b_by = bound(nb, 10.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("flash_bwd", shape, max((a.float() - r.float()).abs().max().item() for a, r in zip(got, want)),
           max(row_rel_err(a, r, floor=eps * eps) for a, r in zip(got, want)), FLASH_BWD_ROW_REL,
           ms=time_ms(lambda: flashex.flash_attention_bwd(dout, q, k, v, out, lse, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True,
                                                                      scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=_sdpa_bwd_library_ms(q, k, v, dout, scale))
    del got, want, q, k, v, out, lse, dout
    torch.cuda.empty_cache()

    N, V = B * SEQ, cfg.padded_vocab_size
    logits = torch.randn((N, V), generator=gen, device="cuda")
    targets = torch.randint(0, cfg.vocab_size, (N,), generator=gen, device="cuda")
    targets[::97] = -100
    shape = f"{N}x{V}"
    got = fusedex.cross_entropy_rows(logits, targets, -100)
    want = fusedex.cross_entropy_rows_plain(logits, targets, -100)
    b_ms, b_by = bound(logits.numel() * 4 + targets.numel() * 8 + N * 4, 4.0 * N * V, PEAK_F32_FLOPS)
    record("ce_fwd", shape, (got - want).abs().max().item(), row_rel_err(got[:, None], want[:, None]), 1e-5,
           ms=time_ms(lambda: fusedex.cross_entropy_rows(logits, targets, -100), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_rows_plain(logits, targets, -100), 10),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    row_scale = fusedex.ce_row_scale(torch.ones((), device="cuda"), targets, -100, "mean")
    got = fusedex.cross_entropy_bwd(logits, targets, row_scale)
    want = fusedex.cross_entropy_bwd_plain(logits, targets, row_scale)
    b_ms, b_by = bound(logits.numel() * 4 * 2 + targets.numel() * 8 + N * 4, 5.0 * N * V, PEAK_F32_FLOPS)
    record("ce_bwd", shape, (got - want).abs().max().item(), row_rel_err(got, want), CE_BWD_ROW_REL,
           ms=time_ms(lambda: fusedex.cross_entropy_bwd(logits, targets, row_scale), 20),
           plain_ms=time_ms(lambda: fusedex.cross_entropy_bwd_plain(logits, targets, row_scale), 10),
           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del got, want, logits
    torch.cuda.empty_cache()


# The recompute-path backward against the plain recompute end to end: the
# two forwards' outputs differ by up to FLASH_ROW_REL, which moves Di = rowsum(
# dout*out) and with it every dS; twice the residual backward's limit. Set
# from that reasoning before any reading (the CUDA tests hold it too).
FLASH_RECOMPUTE_ROW_REL = 2.0 ** -4
# The masked cases of phase 3: (label, Tq, padding, causal). The path's own
# case first (row 0 left-padded by 512 tokens, causal): its timings are the
# row's. A key-padding mask (the "keypad" case) runs full attention, every
# query valid.
MASK_CASES = (("left512", SEQ, ("left", 0, 512), True), ("right300", SEQ, ("right", 1, 300), True),
              ("keypad", SEQ, ("left", 0, 512), False), ("Tq1024", SEQ // 2, ("left", 0, 512), True))


def _segments(B: int, Tq: int, Tkv: int, padding, causal: bool):
    """(q_seg, kv_seg) int32 on the card, 1 valid and 0 pad, as the flash
    executor's plan gives them: batch row ``padding[1]`` padded by
    ``padding[2]`` tokens on the ``padding[0]`` side; under a causal 4-D
    mask the queries are the last Tq key positions, under a key-padding
    mask every query is valid."""
    import torch

    side, row, n = padding
    kv = torch.ones((B, Tkv), dtype=torch.int32, device="cuda")
    if side == "left":
        kv[row, :n] = 0
    else:
        kv[row, Tkv - n:] = 0
    q = kv[:, Tkv - Tq:].contiguous() if causal else torch.ones((B, Tq), dtype=torch.int32, device="cuda")
    return q, kv


def _valid_pairs(q_seg, kv_seg, causal: bool) -> int:
    """(query, key) pairs between valid tokens that attention must compute
    (the bound's work): both segment ids 1, and j <= i + Tkv - Tq if causal."""
    import torch

    Tq, Tkv = q_seg.shape[1], kv_seg.shape[1]
    i = torch.arange(Tq, device="cuda")[:, None]
    j = torch.arange(Tkv, device="cuda")[None, :]
    vis = (q_seg[:, :, None] == 1) & (kv_seg[:, None, :] == 1)
    if causal:
        vis = vis & (j <= i + (Tkv - Tq))[None]
    return int(vis.sum().item())


def check_masked_kernels(cfg, rows: dict) -> None:
    """Kernel rows 9 (flash forward under segment ids) and 8 (the
    recompute-path backward) at the padded path's shapes, B=2, H=32,
    T=2048, D=100 bf16, q and k from rope and v a strided view: row 0
    left-padded by 512 tokens (the path's case, timed), a right-padded row,
    a key-padding mask (full attention) and Tq = 1024 over Tkv = 2048. Each
    against its plain version; then a planted fault (the segments ignored)
    must fail the forward's limit. Every row is compared, pad queries too."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q_full, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    dout_full = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)

    def fold(name, label, err, rel, limit):
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["row_rel_err"] = max(row["row_rel_err"], rel)
        log(f"  {name:8s} {label:>8s} max_abs_err={err:.3e} row_rel_err={rel:.3e} (limit {limit:.3e})")
        require(rel <= limit, f"{name} kernel disagrees with its plain version at {label} ({rel} > {limit})")

    eps = 2.0 ** -7
    for label, Tq, padding, causal in MASK_CASES:
        q, dout = q_full[:, :, SEQ - Tq:], dout_full[:, :, SEQ - Tq:]
        q_seg, kv_seg = _segments(B, Tq, SEQ, padding, causal)
        seg = dict(q_seg=q_seg, kv_seg=kv_seg)

        # -- row 9: the forward under segment ids ----------------------------
        got = flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
        want_out, want_lse = flashex.flash_attention_lse_plain(q, k, v, causal=causal, scale=scale, **seg)
        require(bool(torch.isfinite(got).all()), f"flash_fwd_seg produced non-finite values at {label}")
        err, rel = (got.float() - want_out.float()).abs().max().item(), row_rel_err(got, want_out)
        lse = torch.empty((B, H, Tq), dtype=torch.float32, device="cuda")
        out = flashex._launch_fwd(q, k, v, causal, scale, lse, q_seg, kv_seg)
        lse_rel = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        require(torch.equal(out, got) and lse_rel <= LSE_REL, f"flash_fwd_seg with lse at {label}: lse rel_err "
                                                              f"{lse_rel} (limit {LSE_REL})")
        pairs = _valid_pairs(q_seg, kv_seg, causal)
        seg_bytes = (q_seg.numel() + kv_seg.numel()) * 4
        if label == MASK_CASES[0][0]:
            mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
            mask &= torch.ones((Tq, SEQ), dtype=torch.bool, device="cuda").tril(SEQ - Tq)
            nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2 + seg_bytes
            b_ms, b_by = bound(nb, 4.0 * H * D * pairs, PEAK_BF16_FLOPS)
            _recorder(rows)(
                "flash_fwd_seg", label, err, rel, FLASH_ROW_REL, source="thunder_tpu_torch/csrc/flash_attn.cu",
                replaces="thunder_tpu/executors/flashex.py:355",
                ms=time_ms(lambda: flashex.flash_attention_fwd_seg(q, k, v, q_seg, kv_seg, causal=causal,
                                                                   scale=scale), 20),
                plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=causal, scale=scale, **seg),
                                 3, 1),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 10))
            # The planted fault: the same inputs with the segments ignored.
            wrong = flashex.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
            planted = row_rel_err(wrong, want_out)
            log(f"  flash_fwd_seg planted fault (segments ignored): row_rel_err={planted:.3e} (must exceed "
                f"{FLASH_ROW_REL:.3e})")
            require(planted > FLASH_ROW_REL, "the masked-kernel comparison did not see the segments ignored")
            del wrong
        else:
            fold("flash_fwd_seg", label, err, rel, FLASH_ROW_REL)
        del got, want_out, want_lse

        # -- row 8: the recompute-path backward ------------------------------
        got = flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=causal, scale=scale, **seg)
        require(all(bool(torch.isfinite(g).all()) for g in got), f"flash_bwd_recompute non-finite at {label}")
        want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal, scale=scale, **seg)
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
        del want
        e2e = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal, scale=scale, **seg)
        rel_e2e = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, e2e))
        log(f"  flash_bwd_recompute {label}: against the plain recompute end to end row_rel_err={rel_e2e:.3e} "
            f"(limit {FLASH_RECOMPUTE_ROW_REL:.3e})")
        require(rel_e2e <= FLASH_RECOMPUTE_ROW_REL, f"flash_bwd_recompute differs from the plain recompute at {label}")
        del e2e
        if label == MASK_CASES[0][0]:
            # Read q, k, v, dout and the segments once; write dq, dk, dv once.
            nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()) * 2 + dout.numel() * 2 + seg_bytes
            b_ms, b_by = bound(nb, (4.0 + 10.0) * H * D * pairs, PEAK_BF16_FLOPS)
            qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

            def library():  # the same function in one PyTorch call each way: SDPA forward, autograd backward
                ref = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
                return torch.autograd.grad(ref, (qr, kr, vr), dout)

            _recorder(rows)(
                "flash_bwd_recompute", label, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
                replaces="thunder_tpu/executors/flashex.py:474",
                ms=time_ms(lambda: flashex.flash_attention_bwd_recompute(dout, q, k, v, causal=causal, scale=scale,
                                                                         **seg), 10),
                plain_ms=time_ms(lambda: flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=causal,
                                                                                     scale=scale, **seg), 3, 1),
                bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10))
            del qr, kr, vr, mask
        else:
            fold("flash_bwd_recompute", label, err, rel, FLASH_BWD_ROW_REL)
        del got, out, lse
        torch.cuda.empty_cache()
    del q_full, k, v, dout_full
    torch.cuda.empty_cache()


def check_legacy_kernels(cfg, rows: dict) -> None:
    """Kernel row 10, the legacy route (``_legacy_flash``), at the training
    path's (2, 32, 2048, 100) bf16 causal, q and k from rope and v a strided
    view: its forward wrapper against ``flash_attention_plain`` (row 1's
    limit), its backward (the forward with lse, then the backward kernel)
    against the plain backward from that forward's (out, lse) (row 7's
    limit) and against the plain recompute end to end (row 8's)."""
    import torch
    import torch.nn.functional as F

    from thunder_tpu_torch.executors import flashex, fusedex

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, H, D = LOSS_BATCH, cfg.n_head, cfg.head_size
    scale = 1.0 / math.sqrt(D)
    q_view, k_view, v, cos, sin = _path_inputs(cfg, B, gen)
    q, k = fusedex.apply_rope(q_view, cos, sin), fusedex.apply_rope(k_view, cos, sin)
    del q_view, k_view
    dout = torch.randn((B, SEQ, H, D), generator=gen, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    pairs = SEQ * (SEQ + 1) // 2
    record = _recorder(rows)

    got = flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale)
    want = flashex.flash_attention_plain(q, k, v, causal=True, scale=scale)
    require(bool(torch.isfinite(got).all()), "legacy_flash_fwd produced non-finite values")
    nb = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
    b_ms, b_by = bound(nb, 4.0 * B * H * D * pairs, PEAK_BF16_FLOPS)
    record("legacy_fwd", B, (got.float() - want.float()).abs().max().item(), row_rel_err(got, want), FLASH_ROW_REL,
           source="thunder_tpu_torch/csrc/flash_attn.cu", replaces="thunder_tpu/executors/flashex.py:422",
           ms=time_ms(lambda: flashex.legacy_flash_fwd(q, k, v, causal=True, scale=scale), 20),
           plain_ms=time_ms(lambda: flashex.flash_attention_plain(q, k, v, causal=True, scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by,
           library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
    del got, want

    eps = 2.0 ** -7
    got = flashex.legacy_flash_bwd(dout, q, k, v, causal=True, scale=scale)
    require(all(bool(torch.isfinite(g).all()) for g in got), "legacy_flash_bwd produced non-finite values")
    lse = torch.empty((B, H, SEQ), dtype=torch.float32, device="cuda")
    out = flashex._launch_fwd(q, k, v, True, scale, lse)
    want = flashex.flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=True, scale=scale)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    rel = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, want))
    del want, out, lse
    e2e = flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=True, scale=scale)
    rel_e2e = max(row_rel_err(g, w, floor=eps * eps) for g, w in zip(got, e2e))
    log(f"  legacy_bwd: against the plain recompute end to end row_rel_err={rel_e2e:.3e} "
        f"(limit {FLASH_RECOMPUTE_ROW_REL:.3e})")
    require(rel_e2e <= FLASH_RECOMPUTE_ROW_REL, "legacy_flash_bwd differs from the plain recompute")
    del e2e
    # Read q, k, v and dout once; write dq, dk, dv once. The recomputed
    # forward's 4 FLOP per pair and the backward's 10.
    nb = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + dout.numel()) * 2
    b_ms, b_by = bound(nb, (4.0 + 10.0) * B * H * D * pairs, PEAK_BF16_FLOPS)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def library():  # the same function in one PyTorch call each way: SDPA forward, autograd backward
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        return torch.autograd.grad(ref, (qr, kr, vr), dout)

    record("legacy_bwd", B, err, rel, FLASH_BWD_ROW_REL, source="thunder_tpu_torch/csrc/flash_bwd.cu",
           replaces="thunder_tpu/executors/flashex.py:422",
           ms=time_ms(lambda: flashex.legacy_flash_bwd(dout, q, k, v, causal=True, scale=scale), 10),
           plain_ms=time_ms(lambda: flashex.flash_attention_bwd_recompute_plain(dout, q, k, v, causal=True,
                                                                                scale=scale), 3, 1),
           bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10))
    del got, qr, kr, vr, q, k, v, dout
    torch.cuda.empty_cache()


# =============================================================================
# Phases 4 and 5: the whole path
# =============================================================================


def _wrappers() -> dict:
    """Each kernel's wrapper by row name. The rope backward is the rope
    kernel's wrapper: its launches are those made during a backward."""
    from thunder_tpu_torch.executors import flashex, fusedex, normex

    return {"flash_fwd": flashex.flash_attention_fwd, "rope": fusedex.apply_rope,
            "ce_fwd": fusedex.cross_entropy_rows, "flash_fwd_lse": flashex.flash_attention_fwd_lse,
            "flash_bwd": flashex.flash_attention_bwd, "ce_bwd": fusedex.cross_entropy_bwd,
            "rms_fwd": normex.rms_norm_fwd, "rms_bwd": normex.rms_norm_bwd,
            "ln_fwd": normex.layer_norm_fwd, "ln_bwd": normex.layer_norm_bwd,
            "flash_fwd_seg": flashex.flash_attention_fwd_seg, "flash_bwd_recompute": flashex.flash_attention_bwd_recompute,
            "sdpa_exact": flashex.sdpa_exact, "legacy_fwd": flashex.legacy_flash_fwd,
            "legacy_bwd": flashex.legacy_flash_bwd}


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
        log(f"  {label}: first call (trace + eager warm-up) {times[0]:.3f} s, then (capture, replay) "
            f"{', '.join(f'{x:.4f}' for x in times[1:])} s/call; staged {tt.last_staging(fn).staged}; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        for k, n in per_call.items():
            require(counts[k] == n * calls, f"{label}: {k} launched {counts[k]} times, expected {n * calls}")
        st = tt.last_staging(fn)
        require(st.staged and st.captures == 1 and st.replays == calls - 1, f"{label}: not staged as expected: {st}")
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


def staging_summary(label: str, losses: list, times: list, peak: int, prof: dict) -> dict:
    """Log one run of a training step: s/step (host clock around each step,
    ending in a synchronize), the enqueue ms, busy share and device ms of
    ``profile_call``'s timed and profiled calls, peak memory, the losses."""
    log(f"  {label}: {', '.join(f'{x:.4f}' for x in times)} s/step; profiled: wall "
        f"{', '.join(f'{x:.2f}' for x in prof['wall_ms'])} ms, enqueue {', '.join(f'{x:.2f}' for x in prof['enqueue_ms'])}"
        f" ms, device {prof['device_ms']:.2f} ms, busy {prof['busy_share']:.4f}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; loss {', '.join(f'{x:.6f}' for x in losses)}")
    return dict(losses=losses, times=times, peak=peak, wall_ms=prof["wall_ms"], enqueue_ms=prof["enqueue_ms"],
                device_ms=prof["device_ms"], busy=prof["busy_share"])


def compare_staging(label: str, eager: dict, staged: dict) -> None:
    """The staged step against the unstaged one from the same initial state:
    the first TRAIN_STEPS losses within LOSS_REL (the 2-layer loss limit),
    and whether they are bit-equal."""
    n = TRAIN_STEPS
    worst = max(abs(a - b) / abs(b) for a, b in zip(staged["losses"][:n], eager["losses"][:n]))
    log(f"  {label}: staged vs unstaged losses bit-equal {staged['losses'][:n] == eager['losses'][:n]}, "
        f"worst rel_err {worst:.3e} (limit {LOSS_REL:.0e}); s/step {min(staged['times'][2:]):.4f} vs "
        f"{min(eager['times'][1:]):.4f}; enqueue {min(staged['enqueue_ms']):.2f} vs {min(eager['enqueue_ms']):.2f} "
        f"ms; busy {staged['busy']:.4f} vs {eager['busy']:.4f}; peak {staged['peak'] / 2**30:.2f} vs "
        f"{eager['peak'] / 2**30:.2f} GiB")
    require(worst <= LOSS_REL, f"{label}: the staged step's losses differ from the unstaged step's")


def run_train(cfg, launches: dict) -> list:
    """``build_train`` on the full model at B=2, T=2048, then 3 unstaged
    steps. Each is driven through its parts (forward, backward, SGD), with
    the launch counts zeroed before and read after the forward and the
    backward, so the rope's forward and backward launches are told apart.
    Then the params are put back and the staged step (``Train.step``, one
    CUDA graph) runs 3 steps from the same state, its launches checked per
    step and its losses against the unstaged ones; then each step is timed
    and profiled (``profile_call``). Returns the unstaged losses."""
    import torch

    from thunder_tpu_torch.benchmarks import train
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.parallel.train import scalar_as

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

    initial = [p.detach().to("cpu") for p in tr.flat_params]  # host memory: the peaks below are the step's own
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
            # SGD in place, bf16-true: the same four roundings, with the
            # scalars in bf16 as JAX's weak typing takes them, recomputed.
            upd = torch.mul(p0, scalar_as(train.WD, p0.dtype))
            upd = torch.add(g0, upd)
            upd.mul_(scalar_as(train.LR, p0.dtype))
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
    eager_losses = losses
    eager = staging_summary("unstaged step", losses, times, peak, profile_call("train_step_unstaged", tr.step_eager,
                                                                               batch=LOSS_BATCH, seq=SEQ))
    staged = run_staged_train(tr, initial, {**per_fw, "rope": per_fw["rope"] + per_bw["rope_bwd"],
                                            "flash_bwd": per_bw["flash_bwd"], "ce_bwd": per_bw["ce_bwd"]}, launches)
    compare_staging(f"train B={LOSS_BATCH} T={SEQ}", eager, staged)
    return eager_losses


def run_staged_train(tr, initial: list, per_step: dict, launches: dict) -> dict:
    """``tr``'s params put back to ``initial``, then ``Train.step`` (staged)
    for TRAIN_STEPS steps: the warm-up, the capture (with its first replay)
    and replays, each step's launches against ``per_step``; then timed and
    profiled replays. Returns its summary."""
    import torch

    with torch.no_grad():
        for p, p0 in zip(tr.flat_params, initial):
            p.copy_(p0)
    initial.clear()
    gc.collect()
    torch.cuda.empty_cache()
    times, losses = [], []
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()  # the capture's pool counts
        _zero_counts()
        t = time.perf_counter()
        loss = tr.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        counts = _launch_counts()
        got = {k: counts[k] for k in per_step}
        require(got == per_step, f"staged train step {step + 1}: launches {got}, the traces claim {per_step}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    st = tr.staging
    log(f"  staged step: warm-up {st.first_call_s:.3f} s, capture with its first replay {st.capture_s:.3f} s, "
        f"captures {st.captures}, replays {st.replays}, guard misses {st.guard_misses}, bytes copied per call "
        f"{st.copied_bytes_per_call}")
    require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the train step did not stage: {st}")
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call

    return staging_summary("staged step", losses, times, peak,
                           profile_call("train_step_staged", tr.step, batch=LOSS_BATCH, seq=SEQ))


# =============================================================================
# Phase 7: pythia-410m at full width, 2 layers, with the norm executor
# =============================================================================

PYTHIA = "pythia-410m"
NORM_STACK = "norm,flash,fused,torch"
# The +norm stack against the torch executor alone. They hold attention's
# bf16 roundings apart as in phase 4, and the norm kernels apply the weight
# in f32 where the decomposition rounds the normed value first (one bf16
# ulp). Set from a sound run's readings (logits 1.28e-2, loss 5.4e-6, worst
# grad 1.03e-2; PERF.md): about 2.5 times each. A planted fault in the
# LayerNorm forward (no bias) must exceed the forward's limits, and one in
# its backward (no db) the gradients'.
PYTHIA_LOGITS_ROW_REL = 2.0 ** -5
PYTHIA_LOSS_REL = 2e-5
PYTHIA_GRAD_REL = 2.0 ** -5


def _perturbed_params(cfg, gen):
    """Random params whose norm weights and biases and linear biases are
    drawn away from their init (ones and zeros), so that a norm kernel that
    drops its bias, or a linear that drops its own, shows."""
    import torch

    from thunder_tpu_torch.models import gpt

    params = gpt.init_params(cfg, seed=SEED, device="cuda")

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "weight":  # a norm's weight
                v.add_((0.1 * torch.randn(v.shape, generator=gen, device="cuda")).to(v.dtype))
            elif k == "bias" or k.endswith("_b"):
                v.copy_(0.02 * torch.randn(v.shape, generator=gen, device="cuda"))

    for block in params["blocks"]:
        perturb(block)
    perturb(params["ln_f"])
    return params


def check_pythia_two_layers(cfg) -> None:
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import normex
    from thunder_tpu_torch.models import gpt

    cfg2 = replace(cfg, name=cfg.name + "-2layer", n_layer=2)
    params = _perturbed_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    idx = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    tgt = torch.from_numpy(rng.randint(0, cfg2.vocab_size, (LOSS_BATCH, SEQ))).cuda()
    names = [pytree.keystr(k) for k, _ in pytree.tree_flatten_with_path(params)[0]]
    stack = NORM_STACK.split(",")

    def run(executors):
        fwd = tt.jit(lambda p, i: gpt.forward(p, i, cfg2), executors=executors)
        vg = tt.value_and_grad(lambda p, i, t: gpt.loss_fn(p, i, t, cfg2), executors=executors)
        logits = fwd(params, idx).float()
        loss, g = vg(params, idx, tgt)
        out = logits, float(loss), [x.float() for x in g]
        torch.cuda.synchronize()
        if executors is not None and "norm" in executors:
            src = tt.last_traces(vg)[-1].python()
            n = 2 * cfg2.n_layer + 1
            require(src.count("norm_layer_norm(") == n and src.count("norm_layer_norm_bwd(") == n,
                    "the 2-layer +norm trace does not claim every LayerNorm")
        return out

    want_logits, want_loss, want_grads = run(["torch"])

    def compare(label, logits, loss, grads) -> tuple[bool, bool]:
        """(forward within its limits, gradients within theirs)."""
        rel = row_rel_err(logits, want_logits)
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(grads, want_grads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        fwd_ok = math.isfinite(loss) and rel <= PYTHIA_LOGITS_ROW_REL and loss_rel <= PYTHIA_LOSS_REL
        grad_ok = all(math.isfinite(r) for r in rels) and rels[worst] <= PYTHIA_GRAD_REL
        log(f"  2-layer {label}: logits B={LOSS_BATCH} row_rel_err={rel:.3e} (limit {PYTHIA_LOGITS_ROW_REL:.3e}); "
            f"loss {loss:.6f} vs torch {want_loss:.6f} rel_err={loss_rel:.3e} (limit {PYTHIA_LOSS_REL:.0e}) -> "
            f"{'pass' if fwd_ok else 'FAIL'}; grads worst norm-relative error {rels[worst]:.3e} on {names[worst]} "
            f"(limit {PYTHIA_GRAD_REL:.3e}), median {sorted(rels)[len(rels) // 2]:.3e} -> "
            f"{'pass' if grad_ok else 'FAIL'}")
        return fwd_ok, grad_ok

    sound = compare("+norm", *run(stack))
    real_fwd, real_bwd = normex.layer_norm_fwd, normex.layer_norm_bwd

    def planted_fwd(x, weight, bias, eps=1e-5):
        return real_fwd(x, weight, None, eps)

    def planted_bwd(g, x, weight, eps=1e-5, *, with_bias):
        dx, dw, db = real_bwd(g, x, weight, eps, with_bias=with_bias)
        return dx, dw, None if db is None else torch.zeros_like(db)

    planted_fwd.launches = planted_bwd.launches = 0  # the kernels count their launches on the module's names
    seen = {}
    for part, label, name, fake in (
            (0, "planted fault (LayerNorm forward without its bias)", "layer_norm_fwd", planted_fwd),
            (1, "planted fault (LayerNorm backward without db)", "layer_norm_bwd", planted_bwd)):
        real = getattr(normex, name)
        setattr(normex, name, fake)
        try:
            seen[label] = not compare(label, *run(stack))[part]
        finally:
            setattr(normex, name, real)
    require(all(sound), "the 2-layer pythia model with the norm kernels differs from the torch executor")
    for label, failed in seen.items():
        require(failed, f"the 2-layer pythia comparison did not see a {label}")
    del params, want_grads, want_logits


# =============================================================================
# Phases 8 and 9: the LitGPT training benchmark (benchmarks/litgpt.py)
# =============================================================================

# Each claimed op of the joint trace and the kernel wrapper that runs it.
CLAIMED = {"flash_fwd_lse": "flash_sdpa_fwd_res(", "flash_bwd": "flash_sdpa_bwd_res(", "rope": "fused_apply_rope(",
           "ce_fwd": "fused_cross_entropy(", "ce_bwd": "fused_cross_entropy_bwd(", "rms_fwd": "norm_rms_norm(",
           "rms_bwd": "norm_rms_norm_bwd(", "ln_fwd": "norm_layer_norm(", "ln_bwd": "norm_layer_norm_bwd(",
           "flash_fwd": "flash_scaled_dot_product_attention("}


def run_litgpt(model: str, stack: str, expected: dict, launches: dict, *, optimizer: str, warmup: int,
               iters: int) -> dict:
    """``litgpt.run_one`` on ``model`` at B=2, T=2048 with the executors
    ``stack``: prints its summary, checks the claimed ops per step against
    ``expected`` and the launches of the run against the claims, and adds
    them to ``launches``. Returns the summary and the run (its state after
    the last step)."""
    import torch

    from thunder_tpu_torch.benchmarks import litgpt
    from thunder_tpu_torch.models import gpt

    gc.collect()
    torch.cuda.empty_cache()
    args = litgpt.parse_args(["--model", model, "--micro-batch", str(LOSS_BATCH), "--seq", str(SEQ),
                              "--iters", str(iters), "--warmup", str(warmup), "--optimizer", optimizer])
    t0 = time.perf_counter()
    run = litgpt.prepare(args, stack)
    torch.cuda.synchronize()
    src = run.extrace.python()
    claimed = {k: src.count(v) for k, v in CLAIMED.items()}
    log(f"  {model} [{stack}] built in {time.perf_counter() - t0:.3f} s (init_params, trace, claim); "
        f"claimed per step {claimed}")
    require(claimed == {k: expected.get(k, 0) for k in CLAIMED},
            f"{model} [{stack}]: the claimed trace holds {claimed}, expected {expected}")
    _zero_counts()
    summary = litgpt.run_one(args, stack, prepared=run)
    counts = _launch_counts()
    steps = warmup + iters
    log(f"  {json.dumps(summary)}")
    log(f"  {model} [{stack}]: {summary['median_iter_time_s']} s/iter (median of {iters}), "
        f"{summary['tokens_per_sec']} tokens/s, MFU {summary.get('mfu')} of 989 TFLOP/s, "
        f"peak {summary['memory_used_GB']} GB, loss {summary['loss_first']} -> {summary['loss_last']}; "
        f"launches over {steps} steps {counts}")
    for k, n in claimed.items():
        require(counts[k] == n * steps, f"{model} [{stack}]: {k} launched {counts[k]} times in {steps} steps, "
                                        f"the trace claims {n} a step")
        launches[k] = launches.get(k, 0) + counts[k]
    losses = [float(x) for x in run.losses]
    ln_v = math.log(gpt.name_to_config(model).vocab_size)
    require(all(math.isfinite(x) for x in losses) and abs(losses[0] - ln_v) < 2.0,
            f"{model} [{stack}]: the first loss {losses[0]} is not near ln V = {ln_v:.4f}")
    return summary, run


def compare_litgpt_staging(model: str, stack: str) -> None:
    """The LitGPT step of ``model`` (AdamW, ``stack``) unstaged
    (``step.eager``) and staged, each from a fresh ``litgpt.prepare`` (the
    same seed-0 weights and batch): TRAIN_STEPS steps each, then timed and
    profiled (``profile_call``); the losses compared."""
    import torch

    from thunder_tpu_torch.benchmarks import litgpt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call

    args = litgpt.parse_args(["--model", model, "--micro-batch", str(LOSS_BATCH), "--seq", str(SEQ)])
    out = {}
    for mode in ("unstaged", "staged"):
        gc.collect()
        torch.cuda.empty_cache()
        run = litgpt.prepare(args, stack)
        fn = run.step if mode == "staged" else run.step.eager
        state = [run.params, run.opt]

        def one():
            state[0], state[1], loss = fn(state[0], state[1], run.idx, run.tgt)
            return loss

        times, losses = [], []
        for i in range(TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = one()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        if mode == "staged":
            st = run.step.staging
            log(f"  staged step: warm-up {st.first_call_s:.3f} s, capture with its first replay {st.capture_s:.3f} s, "
                f"guard misses {st.guard_misses}, bytes copied per call {st.copied_bytes_per_call}")
            require(st.staged and st.captures == 1 and st.guard_misses == 0, f"the LitGPT step did not stage: {st}")
        out[mode] = staging_summary(f"{model} [{stack}] {mode} step", losses, times, peak,
                                    profile_call(f"litgpt_step_{mode}", one, batch=LOSS_BATCH, seq=SEQ, config=model,
                                                 executors=stack, optimizer="adamw"))
        del run, fn, state, one
    compare_staging(f"{model} [{stack}]", out["unstaged"], out["staged"])


def check_adamw_step(run) -> None:
    """One more step of ``run`` (a ``litgpt.prepare`` AdamW run), with
    lm_head_w's new value, moments and step count held against the AdamW
    formula recomputed here from its grad (the claimed program's own, at
    the same params): the JAX package's arithmetic in bf16, op by op."""
    import torch

    from thunder_tpu_torch.core.pytree import tree_flatten
    from thunder_tpu_torch.parallel.train import scalar_as

    lr, wd, b1, b2, eps = 3e-4, 0.1, 0.9, 0.95, 1e-8  # litgpt's --lr default; build_train_step's defaults
    p0, m0, v0 = run.params["lm_head_w"], run.opt["m"]["lm_head_w"].clone(), run.opt["v"]["lm_head_w"].clone()
    step0 = int(run.opt["step"])
    flat = tree_flatten(run.params)[0]
    i = next(j for j, p in enumerate(flat) if p is p0)
    with torch.no_grad():
        _, grads = run.step.loss_and_grads(*flat, run.idx, run.tgt)
    g = grads[i].float().to(p0.dtype)
    del grads, flat
    run.fn()
    r = lambda x: scalar_as(x, p0.dtype)  # noqa: E731
    m = m0 * r(b1) + g * r(1 - b1)
    v = v0 * r(b2) + (g * g) * r(1 - b2)
    t = torch.tensor(float(step0 + 1), device=p0.device)
    c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    update = (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps) + wd * p0.float()
    want = p0 - update.to(p0.dtype) * r(lr)
    p1, m1, v1 = run.params["lm_head_w"], run.opt["m"]["lm_head_w"], run.opt["v"]["lm_head_w"]
    ok = torch.equal(p1, want) and torch.equal(m1, m) and torch.equal(v1, v) and int(run.opt["step"]) == step0 + 1
    moved = (p1 != p0).float().mean().item()
    log(f"  AdamW step {step0 + 1} on lm_head_w: params, moments and step equal to the recomputed formula {ok} "
        f"(max |param diff| {(p1.float() - want.float()).abs().max().item():.3e}); {moved:.4%} of its values moved")
    require(ok, "the AdamW update of lm_head_w differs from the formula")
    require(moved > 0, "the AdamW step moved no value of lm_head_w")


# =============================================================================
# Phases 10 and 11: jit(nn.Module) on a padded batch (the Llama stand-in)
# =============================================================================

LLAMA_PAD = {0: 512}  # batch row 0 left-padded by 512 tokens
LLAMA_LR = 6e-4  # bench.py's SGD learning rate
# The ALiBi-like bias through the exact branch against the torch executor's
# decomposition, which rounds q*scale and the scores to bf16 where the exact
# branch keeps f32 scores: four bf16 ulps of the row's largest |value|.
EXACT_ROW_REL = 2.0 ** -5


def check_llama_two_layers() -> None:
    """The stand-in at open_llama_3b's full width with 2 layers through
    ``thunder_tpu_torch.jit(module)`` on the padded batch: the default
    executors against the torch executor alone, for the valid rows' logits
    (without grad), the loss and every parameter's gradient; then with the
    masked forward kernel ignoring its segments (the padding), and the
    recompute backward ignoring them, each of which must fail; then an
    ALiBi-like additive bias on SDPA, which must take the exact branch."""
    import torch.nn.functional as F

    import thunder_tpu_torch as tt
    from thunder_tpu_torch.executors import flashex

    cfg2 = replace(OPEN_LLAMA_3B, num_hidden_layers=2)
    m = llama(cfg2, seed=SEED, device="cuda")
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg2.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    valid = am.bool()

    def run(executors):
        tm = tt.jit(m, executors=executors)
        with torch.no_grad():
            logits = tm(ids, am)["logits"].float()
        out = tm(ids, am, labels)
        out["loss"].backward()
        grads = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return logits, out["loss"].item(), grads

    want_logits, want_loss, want_grads = run(["torch"])

    def compare(label, logits, loss, grads) -> tuple[bool, bool]:
        rel = row_rel_err(logits[valid], want_logits[valid])
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        rels = {n: ((g - want_grads[n]).norm() / want_grads[n].norm().clamp_min(1e-30)).item() for n, g in grads.items()}
        worst = max(rels, key=rels.get)
        fwd_ok = math.isfinite(loss) and rel <= LOGITS_ROW_REL and loss_rel <= LOSS_REL
        grad_ok = all(math.isfinite(r) for r in rels.values()) and rels[worst] <= GRAD_REL
        log(f"  2-layer llama {label}: valid-row logits row_rel_err={rel:.3e} (limit {LOGITS_ROW_REL:.3e}); loss "
            f"{loss:.6f} vs torch {want_loss:.6f} rel_err={loss_rel:.3e} (limit {LOSS_REL:.0e}); worst grad "
            f"norm-relative error {rels[worst]:.3e} on {worst} (limit {GRAD_REL:.3e}) -> forward "
            f"{'pass' if fwd_ok else 'FAIL'}, grads {'pass' if grad_ok else 'FAIL'}")
        return fwd_ok, grad_ok

    _zero_counts()
    sound = compare("kernels", *run(None))
    counts = _launch_counts()
    require(counts["flash_fwd_seg"] == 2 * 2 and counts["flash_bwd_recompute"] == 2 and counts["sdpa_exact"] == 0,
            f"2-layer llama: the masked kernels did not carry attention ({counts})")
    real_fwd, real_bwd = flashex.flash_attention_fwd_seg, flashex.flash_attention_bwd_recompute

    def planted_fwd(q, k, v, q_seg, kv_seg, *, causal, scale):
        return flashex.flash_attention_fwd(q, k, v, causal=True, scale=scale)

    def planted_bwd(dout, q, k, v, *, causal, scale, q_seg=None, kv_seg=None):
        return real_bwd(dout, q, k, v, causal=True, scale=scale)

    planted_fwd.launches = planted_bwd.launches = 0
    flashex.flash_attention_fwd_seg = planted_fwd
    try:
        fault_fwd = compare("planted fault (forward without its padding)", *run(None))
    finally:
        flashex.flash_attention_fwd_seg = real_fwd
    flashex.flash_attention_bwd_recompute = planted_bwd
    try:
        fault_bwd = compare("planted fault (backward without its padding)", *run(None))
    finally:
        flashex.flash_attention_bwd_recompute = real_bwd
    require(all(sound), "2-layer llama with the kernels differs from the torch executor")
    require(not fault_fwd[0], "the 2-layer llama comparison did not see the forward's padding ignored")
    require(not fault_bwd[1], "the 2-layer llama gradient comparison did not see the backward's padding ignored")
    del m, want_logits, want_grads
    gc.collect()
    torch.cuda.empty_cache()

    # An ALiBi-like bias: additive, one slope, -inf above the diagonal. Its
    # entries are neither 0 nor <= -1e9, so the kernels cannot express it.
    class Biased(nn.Module):
        def forward(self, q, k, v, bias):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    H, D = OPEN_LLAMA_3B.num_attention_heads, OPEN_LLAMA_3B.head_dim
    q, k, v = (torch.randn((LOSS_BATCH, H, SEQ, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    i = torch.arange(SEQ, device="cuda")
    dist = (i[:, None] - i[None, :]).float()
    bias = torch.where(dist >= 0, -0.0625 * dist, -math.inf).to(torch.bfloat16)[None, None]
    _zero_counts()
    with torch.no_grad():
        got = tt.jit(Biased())(q, k, v, bias)
        counts = _launch_counts()
        want = tt.jit(Biased(), executors=["torch"])(q, k, v, bias)
    exact = flashex._exact_sdpa(q, k, v, bias, causal=False, scale=1.0 / math.sqrt(D))
    rel = row_rel_err(got, want)
    log(f"  ALiBi-like bias: exact branch taken {counts['sdpa_exact']} time(s), masked kernel "
        f"{counts['flash_fwd_seg']}; equal to the exact arithmetic {torch.equal(got, exact)}; against the torch "
        f"executor row_rel_err={rel:.3e} (limit {EXACT_ROW_REL:.3e})")
    require(counts["sdpa_exact"] == 1 and counts["flash_fwd_seg"] == 0 and counts["flash_fwd"] == 0,
            f"the ALiBi-like bias did not take the exact branch alone ({counts})")
    require(torch.equal(got, exact) and rel <= EXACT_ROW_REL, "the exact branch's values are wrong")


def run_llama(launches: dict) -> None:
    """The stand-in at open_llama_3b's full width and depth (26 layers) on
    the padded batch, B=2 x T=2048, through ``thunder_tpu_torch.jit``:
    the forward without grad (3 calls), the same on an all-ones mask (the
    value guard takes the unmasked causal path), and 3 training steps
    (loss with labels -100 at pads, ``.backward()``, ``torch.optim.SGD``),
    each with its launches checked against the claimed traces; then one
    profiled forward and step (``profile_gpt.profile_call``)."""
    import thunder_tpu_torch as tt
    from thunder_tpu_torch.benchmarks.profile_gpt import profile_call
    from thunder_tpu_torch.executors import flashex

    gc.collect()
    torch.cuda.empty_cache()
    cfg = OPEN_LLAMA_3B
    n = cfg.num_hidden_layers
    t0 = time.perf_counter()
    m = llama(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"  llama init: {time.perf_counter() - t0:.2f} s, {sum(p.numel() for p in m.parameters()) / 1e9:.3f} B params, "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ids, am, labels = padded_batch(LOSS_BATCH, SEQ, cfg.vocab_size, LLAMA_PAD, seed=SEED, device="cuda")
    ones = torch.ones_like(am)
    tm = tt.jit(m)
    stats = tm._lc_cs

    def forward(mask):
        with torch.no_grad():
            return tm(ids, mask)["logits"]

    def drive(label, mask, per_call, calls):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        reads0 = flashex.mask_plan.host_reads
        times = []
        for _ in range(calls):
            t = time.perf_counter()
            out = forward(mask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = _launch_counts()
        reads = flashex.mask_plan.host_reads - reads0
        log(f"  {label}: first call {times[0]:.3f} s, then {', '.join(f'{x:.4f}' for x in times[1:])} s/call; "
            f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; mask verdicts read "
            f"{reads}; launches {counts}")
        for k, v in per_call.items():
            require(counts[k] == v * calls, f"{label}: {k} launched {counts[k]} times, expected {v * calls}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, reads

    none = {"flash_fwd_lse": 0, "flash_bwd": 0, "flash_bwd_recompute": 0, "sdpa_exact": 0, "ce_fwd": 0, "rope": 0}
    logits, reads = drive(f"forward padded B={LOSS_BATCH} T={SEQ}", am, {"flash_fwd_seg": n, "flash_fwd": 0, **none}, 3)
    require(tuple(logits.shape) == (LOSS_BATCH, SEQ, cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits[am.bool()]).all()), "padded forward: valid-row logits are not finite")
    require(reads == 3, f"the mask verdict was read {reads} times in 3 calls, expected once a call")
    require((stats.cache_misses, stats.cache_hits) == (1, 2), "padded forward: expected 1 miss and 2 hits")
    src = tt.last_traces(tm)[-1].python()
    require(src.count("flash_scaled_dot_product_attention(") == n, "the padded forward does not claim every SDPA")
    del logits
    logits, reads = drive("forward all-ones mask", ones, {"flash_fwd": n, "flash_fwd_seg": 0, **none}, 2)
    require(bool(torch.isfinite(logits).all()) and reads == 0, "all-ones forward: non-finite logits or a mask read")
    require((stats.cache_misses, stats.cache_hits) == (2, 3), f"all-ones mask: cache misses/hits "
            f"{stats.cache_misses}/{stats.cache_hits}, expected 2/3 (the value guard's second entry)")
    forward(am)
    require((stats.cache_misses, stats.cache_hits) == (2, 4), "the padded entry was not found again")
    log(f"  value guard: cache misses {stats.cache_misses}, hits {stats.cache_hits}")
    del logits
    gc.collect()
    torch.cuda.empty_cache()

    opt = torch.optim.SGD(m.parameters(), lr=LLAMA_LR)
    weights = torch.cuda.memory_allocated()
    times, losses = [], []
    per_fw = {"flash_fwd_seg": n, "ce_fwd": 1, "sdpa_exact": 0, "flash_fwd": 0, "flash_fwd_lse": 0}
    per_bw = {"flash_bwd_recompute": n, "ce_bwd": 1, "sdpa_exact": 0, "flash_bwd": 0, "flash_fwd_seg": 0}
    for step in range(TRAIN_STEPS):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _zero_counts()
        out = tm(ids, am, labels)
        fw_counts = _launch_counts()
        _zero_counts()
        out["loss"].backward()
        bw_counts = _launch_counts()
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(out["loss"].item())
        del out
        if step == 0:
            fw_src, bw_src = tt.last_traces(tm)[-1].python(), stats.last_backward_traces[-1].python()
            claimed = {"flash_fwd_seg": fw_src.count("flash_scaled_dot_product_attention("),
                       "ce_fwd": fw_src.count("fused_cross_entropy("),
                       "flash_bwd_recompute": bw_src.count("flash_sdpa_bwd("),
                       "ce_bwd": bw_src.count("fused_cross_entropy_bwd(")}
            log(f"  train: claimed per step {claimed}; weights {weights / 2**30:.2f} GiB")
            require(claimed == {"flash_fwd_seg": n, "ce_fwd": 1, "flash_bwd_recompute": n, "ce_bwd": 1},
                    "the training traces do not claim every SDPA, SDPA backward and cross-entropy")
        for want, got in ((per_fw, fw_counts), (per_bw, bw_counts)):
            bad = {k: got[k] for k, v in want.items() if got[k] != v}
            require(not bad, f"train step {step + 1}: launches {bad}, expected {want}")
        for counts in (fw_counts, bw_counts):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    log(f"  llama train B={LOSS_BATCH} T={SEQ}: step 1 {times[0]:.4f} s, then "
        f"{', '.join(f'{x:.4f}' for x in times[1:])} s/step; max_memory_allocated (steps 2-{TRAIN_STEPS}) = "
        f"{peak / 2**30:.2f} GiB; loss {', '.join(f'{x:.6f}' for x in losses)}")
    require(all(math.isfinite(x) and abs(x - math.log(cfg.vocab_size)) < 2.0 for x in losses),
            "llama training loss is not near ln V")
    require(losses[-1] < losses[0], "llama training loss did not fall")

    def step():
        out = tm(ids, am, labels)
        out["loss"].backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    # The mask verdict's own cost: the checks over the path's (2, 1, 2048,
    # 2048) mask and the host read, on an idle card, for a fresh mask each
    # time (the memo would answer a repeat).
    mask = m.model.causal_mask(am, SEQ)
    q = torch.empty((LOSS_BATCH, cfg.num_attention_heads, SEQ, cfg.head_dim), dtype=torch.bfloat16, device="cuda")
    costs = []
    for _ in range(5):
        fresh = mask.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        plan = flashex.mask_plan(fresh, q, q, False)
        costs.append((time.perf_counter() - t) * 1e3)
    require(plan.flash and plan.causal, "the path's mask did not verify as causal∧padding")
    log(f"  mask verdict on the path's mask, idle card: {', '.join(f'{x:.3f}' for x in costs)} ms")
    del mask, q, fresh, plan

    reads0 = flashex.mask_plan.host_reads
    profile_call("llama_forward_padded", lambda: forward(am), batch=LOSS_BATCH, seq=SEQ, config="open_llama_3b",
                 module="chip_smoke.LlamaForCausalLM")
    profile_call("llama_train_step_padded", step, batch=LOSS_BATCH, seq=SEQ, config="open_llama_3b", optimizer="sgd",
                 module="chip_smoke.LlamaForCausalLM")
    log(f"  mask verdicts read over the 10 profiled calls: {flashex.mask_plan.host_reads - reads0}")


def run_legacy_train(cfg, splash_losses: list, launches: dict) -> None:
    """``build_train`` and 3 staged steps (``Train.step``) of the full
    open_llama_3b under ``THUNDER_FLASH_IMPL=legacy``: the claimed traces
    hold the legacy route (no residual pair), each step launches row 10's
    wrappers as often as they claim, and the losses are the splash route's
    of phase 6 (the same function) within LOSS_REL. The variable is
    restored afterwards."""
    import os

    import torch

    from thunder_tpu_torch.benchmarks import train

    gc.collect()
    torch.cuda.empty_cache()
    prev = os.environ.get("THUNDER_FLASH_IMPL")
    os.environ["THUNDER_FLASH_IMPL"] = "legacy"
    try:
        t0 = time.perf_counter()
        tr = train.build_train(cfg, LOSS_BATCH, SEQ, device="cuda", seed=SEED)
        build_s = time.perf_counter() - t0
        src = tr.fw_trace.python() + tr.bw_trace.python()
        per_step = {"legacy_fwd": src.count("flash_scaled_dot_product_attention("),
                    "legacy_bwd": src.count("flash_sdpa_bwd("), "flash_fwd": 0, "flash_fwd_lse": 0, "flash_bwd": 0,
                    "flash_bwd_recompute": 0}
        log(f"  build_train under legacy: {build_s:.3f} s; claimed per step {per_step}")
        n = cfg.n_layer
        require(per_step["legacy_fwd"] == n and per_step["legacy_bwd"] == n and "sdpa_fwd_res" not in src,
                "the legacy traces do not claim every attention and its recompute backward")
        times, losses = [], []
        for step in range(TRAIN_STEPS):
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t = time.perf_counter()
            loss = tr.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
            counts = _launch_counts()
            got = {k: counts[k] for k in per_step}
            require(got == per_step, f"legacy step {step + 1}: launches {got}, the traces claim {per_step}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated()
        st = tr.staging
        require(st.staged and st.captures == 1, f"the legacy train step did not stage: {st}")
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, splash_losses))
        log(f"  legacy train B={LOSS_BATCH} T={SEQ}, staged: {', '.join(f'{x:.4f}' for x in times)} s/step (warm-up, "
            f"capture, replay); max_memory_allocated (steps 2-{TRAIN_STEPS}) {peak / 2**30:.2f} GiB; loss "
            f"{', '.join(f'{x:.6f}' for x in losses)}; splash route's (phase 6) bit-equal {losses == splash_losses}, "
            f"worst rel_err {worst:.3e} (limit {LOSS_REL:.0e})")
        require(worst <= LOSS_REL, "the legacy route's losses differ from the splash route's")
        del tr
    finally:
        if prev is None:
            os.environ.pop("THUNDER_FLASH_IMPL", None)
        else:
            os.environ["THUNDER_FLASH_IMPL"] = prev


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
        if "Compiling entry" in line or "registers" in line or "spill" in line or line.startswith("nvcc "):
            log(f"  {line.strip()}")

    pythia = gpt.name_to_config(PYTHIA)
    log(f"[3] kernels at {CFG_NAME}'s and {PYTHIA}'s path shapes, and the masked kernels at the padded path's")
    rows: dict[str, dict] = {}
    check_kernels(cfg, rows)
    check_norm_kernels(cfg, pythia, rows)
    check_pythia_shapes(pythia, rows)
    check_masked_kernels(cfg, rows)
    check_legacy_kernels(cfg, rows)

    log(f"[4] {CFG_NAME} at full width, 2 layers: default executors vs torch executor, forward and gradients")
    check_two_layers(cfg)

    log(f"[5] {CFG_NAME}, {cfg.n_layer} layers")
    launches = run_full(cfg)

    log(f"[6] {CFG_NAME}, {cfg.n_layer} layers: training step, unstaged and staged")
    splash_losses = run_train(cfg, launches)

    log(f"[7] {PYTHIA} at full width, 2 layers: {NORM_STACK} vs torch executor, forward and gradients")
    check_pythia_two_layers(pythia)

    n = pythia.n_layer
    log(f"[8] {PYTHIA}, {n} layers: litgpt training benchmark, AdamW, default executors and {NORM_STACK}")
    attn = {"flash_fwd_lse": n, "flash_bwd": n, "ce_fwd": 1, "ce_bwd": 1}
    run_litgpt(PYTHIA, "flash,fused,torch", attn, launches, optimizer="adamw", warmup=2, iters=5)
    _, run = run_litgpt(PYTHIA, NORM_STACK, {**attn, "ln_fwd": 2 * n + 1, "ln_bwd": 2 * n + 1}, launches,
                        optimizer="adamw", warmup=2, iters=5)
    check_adamw_step(run)
    del run
    compare_litgpt_staging(PYTHIA, "flash,fused,torch")

    n = cfg.n_layer
    log(f"[9] {CFG_NAME}, {n} layers: litgpt training benchmark, SGD, {NORM_STACK}")
    run_litgpt(CFG_NAME, NORM_STACK, {"flash_fwd_lse": n, "flash_bwd": n, "ce_fwd": 1, "ce_bwd": 1, "rope": 4 * n,
                                      "rms_fwd": 2 * n + 1, "rms_bwd": 2 * n + 1},
               launches, optimizer="sgd", warmup=2, iters=3)

    log(f"[10] the Llama stand-in at {CFG_NAME}'s full width, 2 layers, padded batch: jit(module) vs torch "
        "executor, forward and gradients; the exact branch")
    check_llama_two_layers()

    log(f"[11] the Llama stand-in, {OPEN_LLAMA_3B.num_hidden_layers} layers, padded batch: forward without grad, "
        "all-ones mask, 3 SGD steps")
    run_llama(launches)

    log(f"[12] {CFG_NAME}, {cfg.n_layer} layers: 3 staged training steps under THUNDER_FLASH_IMPL=legacy")
    run_legacy_train(cfg, splash_losses, launches)

    rows = list(rows.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "row_rel_err", "row_rel_limit",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: (launches[r["name"]] if k == "launches" else r[k]) for k in keys} for r in rows]
    print(json.dumps({"kernels": kernels, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
