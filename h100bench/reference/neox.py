"""A plain float32 GPT-NeoX: forward, loss, backward and AdamW, in ``torch``.

It follows the published description of GPT-NeoX (Black et al., 2022; the
Hugging Face ``GPTNeoXForCausalLM`` of the Pythia checkpoints): token
embedding; per layer a parallel residual, x + attn(LN1(x)) + mlp(LN2(x)), with
LayerNorm, causal multi-head attention whose first ``rotary_pct`` of each
head's features take the rotary embedding (rotate-half, base
``rotary_emb_base``), scores scaled by 1/sqrt(head size), an exact (erf) GELU
MLP with biases; a final LayerNorm and an untied head; the mean next-token
cross-entropy. AdamW is the decoupled one (Loshchilov and Hutter):
p ← p − lr·(m̂/(sqrt(v̂) + eps) + wd·p) with bias-corrected moments.

Departures from the published description, none of which changes the
mathematics:
- The fused qkv weight holds all query heads, then all key heads, then all
  value heads; the checkpoint interleaves them per head. With random weights
  only the convention matters, and both sides read the same tensors.
- Attention is the materialized product, one row of the batch at a time, so
  that it fits on the card at the benchmark's sizes; the loss and its gradient
  are accumulated over the rows.
- Weight decay applies to every weight, biases and norms included, as the
  program's step applies it.
- The weights are stored in the configuration's ``torch_dtype``: after each
  update every weight is rounded to it, as a model trained with its weights
  in bfloat16 ("bf16-true") holds them. Everything else, the moments
  included, is float32. An update smaller than half the type's spacing at a
  weight leaves that weight where it was (bfloat16's spacing at 1.0 is
  2**-7, so at lr 3e-4 the LayerNorm weights, near 1, do not move), on both
  sides alike.

Everything is float32, with TF32 off (``exact()``). Nothing here imports the
program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact() -> None:
    """Float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _rotary(T: int, c: dict, device):
    hs = c["hidden_size"] // c["num_attention_heads"]
    n = int(c["rotary_pct"] * hs)
    inv_freq = 1.0 / (c["rotary_emb_base"] ** (torch.arange(0, n, 2, device=device, dtype=torch.float32) / n))
    freqs = torch.outer(torch.arange(T, device=device, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin(), n


def _rope(x, cos, sin, n):
    """x (H, T, hs): rotate-half on the first n features."""
    rot, rest = x[..., :n], x[..., n:]
    x1, x2 = rot[..., : n // 2], rot[..., n // 2:]
    return torch.cat([rot * cos + torch.cat([-x2, x1], dim=-1) * sin, rest], dim=-1)


def _attention(h, p, c, rope):
    T, d = h.shape
    H = c["num_attention_heads"]
    hs = d // H
    qkv = h @ p["qkv_w"].T + p["qkv_b"]
    q, k, v = (t.reshape(T, H, hs).transpose(0, 1) for t in qkv.split(d, dim=-1))
    q, k = _rope(q, *rope), _rope(k, *rope)
    scores = q @ k.transpose(-1, -2) / math.sqrt(hs)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    att = scores.masked_fill(~causal, float("-inf")).softmax(dim=-1)
    y = (att @ v).transpose(0, 1).reshape(T, d)
    return y @ p["proj_w"].T + p["proj_b"]


def _mlp(h, p):
    return F.gelu(h @ p["fc_w"].T + p["fc_b"]) @ p["proj_w"].T + p["proj_b"]


def logits(params: dict, ids: torch.Tensor, c: dict) -> torch.Tensor:
    """One row of token ids (T,) → logits (T, vocab), float32."""
    eps = c["layer_norm_eps"]
    cos, sin, n = _rotary(ids.shape[0], c, ids.device)
    x = params["wte"][ids]
    for p in params["blocks"]:
        h1 = _layer_norm(x, p["norm_1"], eps)
        a = _attention(h1, p["attn"], c, (cos, sin, n))
        if c["use_parallel_residual"]:
            x = x + a + _mlp(_layer_norm(x, p["norm_2"], eps), p["mlp"])
        else:
            x = x + a
            x = x + _mlp(_layer_norm(x, p["norm_2"], eps), p["mlp"])
    return _layer_norm(x, params["ln_f"], eps) @ params["lm_head_w"].T


def token_losses(params: dict, idx: torch.Tensor, tgt: torch.Tensor, c: dict) -> torch.Tensor:
    """Each token's next-token cross-entropy over a (B, T) batch, (B, T) on
    the host, computed row by row."""
    exact()
    with torch.no_grad():
        return torch.stack([F.cross_entropy(logits(params, idx[b], c), tgt[b], reduction="none").cpu()
                            for b in range(idx.shape[0])])


def loss_and_grads(params: dict, idx: torch.Tensor, tgt: torch.Tensor, c: dict) -> float:
    """The mean cross-entropy over a (B, T) batch; its gradient is left in
    each leaf's ``.grad`` (leaves that require grad), accumulated row by
    row."""
    exact()
    total = 0.0
    for b in range(idx.shape[0]):
        row = F.cross_entropy(logits(params, idx[b], c), tgt[b], reduction="sum")
        (row / idx.numel()).backward()
        total += row.item()
    return total / idx.numel()


class AdamW:
    """Decoupled AdamW over a list of float32 leaves, in place; each weight is
    rounded to ``store`` after its update."""

    def __init__(self, leaves: list, lr: float, b1: float, b2: float, eps: float, weight_decay: float,
                 store: torch.dtype = torch.float32):
        self.leaves, self.lr, self.b1, self.b2, self.eps, self.wd = leaves, lr, b1, b2, eps, weight_decay
        self.store = store
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * update)
            p.copy_(p.to(self.store))
            p.grad = None
