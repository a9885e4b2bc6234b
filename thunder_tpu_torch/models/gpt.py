"""The GPT family: a functional, trace-friendly transformer.

The counterpart of ``thunder_tpu/models/gpt.py``: the same configurations and
the same pure ``forward(params, idx, config)`` / ``loss_fn`` over a nested
params dict, written against this package's torch language so that ``jit``
traces it. The params are torch tensors. ``init_params`` draws them with a
``torch.Generator`` on the device; ``params_from_jax`` loads the JAX
package's params (as numpy arrays) into the same structure, which is how the
tests hold the two packages against each other.

Layout notes:
- qkv is one fused projection (q heads, then k, then v);
- ``tp`` (``forward``/``loss_fn``) is the sharded training step's tensor
  parallelism (``parallel/train.py``): the regions below that run on tp
  blocks (``tp.block``) are the only place that decides which weights are
  read as blocks; a region runs on them where its weight's spec splits it
  over tp (``tp.split_on``). None is the one-device program;
- ``sp`` is the sharded step's sequence parallelism: each rank holds a
  block of consecutive positions, rope takes their global positions
  (``sp.offset``) and attention runs over the whole sequence
  (``sp.attention``: ring attention over the axis). None is the one-device
  program;
- RoPE uses the rotate-half convention with ``rotary_percentage`` of
  head_size rotated; cos/sin are built from iota inside the trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

import thunder_tpu_torch.clang as clang
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core import devices, dtypes


@dataclass(frozen=True)
class GPTConfig:
    name: str = "gpt"
    block_size: int = 2048
    vocab_size: int = 50254
    padded_vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    n_query_groups: Optional[int] = None  # None → MHA (== n_head)
    rotary_percentage: float = 0.25
    parallel_residual: bool = True
    shared_attention_norm: bool = False
    bias: bool = True
    norm_class: str = "LayerNorm"  # or "RMSNorm"
    norm_eps: float = 1e-5
    mlp_class: str = "GptNeoxMLP"  # or "LLaMAMLP" / "MoEMLP"
    intermediate_size: Optional[int] = None
    rope_base: int = 10000
    # MoE (mlp_class="MoEMLP", mixtral-style SwiGLU experts):
    n_expert: int = 0
    n_expert_per_token: int = 2

    @property
    def head_size(self) -> int:
        return self.n_embd // self.n_head

    @property
    def query_groups(self) -> int:
        return self.n_query_groups if self.n_query_groups is not None else self.n_head

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @property
    def mlp_hidden(self) -> int:
        return self.intermediate_size if self.intermediate_size is not None else 4 * self.n_embd

    @property
    def qkv_out(self) -> int:
        return (self.n_head + 2 * self.query_groups) * self.head_size


configs: dict[str, GPTConfig] = {}


def _add(cfg: GPTConfig) -> GPTConfig:
    configs[cfg.name] = cfg
    return cfg


# Tiny configs for tests.
_add(GPTConfig(name="gpt-tiny", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
               n_head=2, n_embd=32, rotary_percentage=1.0, intermediate_size=64))
_add(GPTConfig(name="llama-tiny", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2,
               n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
               parallel_residual=False, bias=False, norm_class="RMSNorm", mlp_class="LLaMAMLP",
               intermediate_size=88))
# open_llama_3b's head size (100) at a test size: the flash kernel pads D to
# 112 and the rope kernel works on 50-wide halves, as on the full model.
_add(GPTConfig(name="llama-hs100-tiny", block_size=128, vocab_size=256, padded_vocab_size=256,
               n_layer=2, n_head=2, n_embd=200, rotary_percentage=1.0, parallel_residual=False,
               bias=False, norm_class="RMSNorm", norm_eps=1e-6, mlp_class="LLaMAMLP",
               intermediate_size=544))

# Pythia (GPT-NeoX) family.
_add(GPTConfig(name="pythia-160m", block_size=2048, vocab_size=50254, padded_vocab_size=50304,
               n_layer=12, n_head=12, n_embd=768, rotary_percentage=0.25, parallel_residual=True,
               bias=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=3072))
_add(GPTConfig(name="pythia-410m", block_size=2048, vocab_size=50254, padded_vocab_size=50304,
               n_layer=24, n_head=16, n_embd=1024, rotary_percentage=0.25, parallel_residual=True,
               bias=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=4096))
_add(GPTConfig(name="pythia-1b", block_size=2048, vocab_size=50254, padded_vocab_size=50304,
               n_layer=16, n_head=8, n_embd=2048, rotary_percentage=0.25, parallel_residual=True,
               bias=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=8192))

# Llama-2 family.
_add(GPTConfig(name="llama-2-7b", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
               n_layer=32, n_head=32, n_embd=4096, rotary_percentage=1.0, parallel_residual=False,
               bias=False, norm_class="RMSNorm", norm_eps=1e-5, mlp_class="LLaMAMLP",
               intermediate_size=11008))
_add(GPTConfig(name="llama-2-13b", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
               n_layer=40, n_head=40, n_embd=5120, rotary_percentage=1.0, parallel_residual=False,
               bias=False, norm_class="RMSNorm", norm_eps=1e-5, mlp_class="LLaMAMLP",
               intermediate_size=13824))
_add(GPTConfig(name="open_llama_3b", block_size=2048, vocab_size=32000, padded_vocab_size=32000,
               n_layer=26, n_head=32, n_embd=3200, rotary_percentage=1.0, parallel_residual=False,
               bias=False, norm_class="RMSNorm", norm_eps=1e-6, mlp_class="LLaMAMLP",
               intermediate_size=8640))

# Mixtral-style MoE family.
_add(GPTConfig(name="mixtral-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
               n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
               parallel_residual=False, bias=False, norm_class="RMSNorm",
               mlp_class="MoEMLP", intermediate_size=64, n_expert=4, n_expert_per_token=2))
_add(GPTConfig(name="mixtral-8x7b", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
               n_layer=32, n_head=32, n_embd=4096, n_query_groups=8, rotary_percentage=1.0,
               parallel_residual=False, bias=False, norm_class="RMSNorm", norm_eps=1e-5,
               mlp_class="MoEMLP", intermediate_size=14336, n_expert=8, n_expert_per_token=2))

# Mistral (GQA).
_add(GPTConfig(name="mistral-7b", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
               n_layer=32, n_head=32, n_embd=4096, n_query_groups=8, rotary_percentage=1.0,
               parallel_residual=False, bias=False, norm_class="RMSNorm", norm_eps=1e-5,
               mlp_class="LLaMAMLP", intermediate_size=14336))

# Falcon family: MQA (one KV head) and a shared-attention-norm parallel residual.
_add(GPTConfig(name="falcon-7b", block_size=2048, vocab_size=65024, padded_vocab_size=65024,
               n_layer=32, n_head=71, n_embd=4544, n_query_groups=1, rotary_percentage=1.0,
               parallel_residual=True, shared_attention_norm=True, bias=False,
               norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=18176))
_add(GPTConfig(name="falcon-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
               n_layer=2, n_head=4, n_embd=32, n_query_groups=1, rotary_percentage=1.0,
               parallel_residual=True, shared_attention_norm=True, bias=False,
               norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=128))

# Phi-2: partial-rotary parallel residual with biases.
_add(GPTConfig(name="phi-2", block_size=2048, vocab_size=50257, padded_vocab_size=51200,
               n_layer=32, n_head=32, n_embd=2560, rotary_percentage=0.4,
               parallel_residual=True, shared_attention_norm=True, bias=True,
               norm_class="LayerNorm", mlp_class="GptNeoxMLP", intermediate_size=10240))


def name_to_config(name: str) -> GPTConfig:
    return configs[name]


# =============================================================================
# Parameters
# =============================================================================


def _param_shapes(C: GPTConfig) -> dict:
    """The params structure as a nested dict of (shape, init) leaves, where
    init is a normal std, or "ones"/"zeros"."""
    out_std = 0.02 / np.sqrt(2 * C.n_layer)

    def norm():
        p = {"weight": ((C.n_embd,), "ones")}
        if C.norm_class == "LayerNorm":
            p["bias"] = ((C.n_embd,), "zeros")
        return p

    def block():
        p: dict[str, Any] = {
            "norm_1": norm(),
            "attn": {"qkv_w": ((C.qkv_out, C.n_embd), 0.02),
                     "proj_w": ((C.n_embd, C.n_head * C.head_size), out_std)},
            "mlp": {},
        }
        if not C.shared_attention_norm:
            p["norm_2"] = norm()
        if C.bias:
            p["attn"]["qkv_b"] = ((C.qkv_out,), "zeros")
            p["attn"]["proj_b"] = ((C.n_embd,), "zeros")
        m, H = p["mlp"], C.mlp_hidden
        if C.mlp_class == "MoEMLP":
            E = C.n_expert
            m["router_w"] = ((E, C.n_embd), 0.02)
            m["w1"] = ((E, H, C.n_embd), 0.02)
            m["w3"] = ((E, H, C.n_embd), 0.02)
            m["w2"] = ((E, C.n_embd, H), out_std)
        elif C.mlp_class == "LLaMAMLP":
            m["fc_1_w"] = ((H, C.n_embd), 0.02)
            m["fc_2_w"] = ((H, C.n_embd), 0.02)
            m["proj_w"] = ((C.n_embd, H), out_std)
            if C.bias:
                m["fc_1_b"] = ((H,), "zeros")
                m["fc_2_b"] = ((H,), "zeros")
                m["proj_b"] = ((C.n_embd,), "zeros")
        else:
            m["fc_w"] = ((H, C.n_embd), 0.02)
            m["proj_w"] = ((C.n_embd, H), out_std)
            if C.bias:
                m["fc_b"] = ((H,), "zeros")
                m["proj_b"] = ((C.n_embd,), "zeros")
        return p

    return {
        "wte": ((C.padded_vocab_size, C.n_embd), 0.02),
        "blocks": [block() for _ in range(C.n_layer)],
        "ln_f": norm(),
        "lm_head_w": ((C.padded_vocab_size, C.n_embd), 0.02),
    }


def _map_spec(spec: Any, fn) -> Any:
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_map_spec(v, fn) for v in spec]
    return fn(*spec)


def init_params(config: GPTConfig, *, dtype=torch.bfloat16, seed: int = 0, device: Any = None) -> dict:
    """Random params, drawn with a ``torch.Generator`` seeded with ``seed``
    on ``device`` (CUDA unless the caller passes ``device="cpu"``; with no
    card that raises). Normals are drawn in float32 and rounded to
    ``dtype``. The numbers differ from the JAX package's init for the same
    seed; tests share weights through ``params_from_jax``."""
    dev = devices.resolve_device(device)
    tdt = dtypes.to_torch_dtype(dtypes.to_dtype(dtype))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, init):
        if init == "ones":
            return torch.ones(shape, dtype=tdt, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=tdt, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(init).to(tdt)

    return _map_spec(_param_shapes(config), make)


def params_from_jax(tree: Any, device: Any = None) -> dict:
    """The JAX package's params, given as numpy arrays in the same nested
    structure, as this package's params on ``device``. Numpy has no
    bfloat16 of its own, so a bfloat16 array (ml_dtypes' type, as
    ``np.asarray`` gives it for a JAX array) goes through float32, which
    holds every bfloat16 value exactly."""
    dev = devices.resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return conv(tree)


# =============================================================================
# Forward
# =============================================================================


def _norm(x, p, config: GPTConfig):
    if config.norm_class == "RMSNorm":
        return ttorch.rms_norm(x, (config.n_embd,), p["weight"], eps=config.norm_eps)
    return ttorch.layer_norm(x, (config.n_embd,), p["weight"], p.get("bias"), eps=config.norm_eps)


def _rope_cache(T: int, config: GPTConfig, device, dtype, offset: int = 0):
    """cos/sin of shape (T, rope_n_elem) for positions offset..offset+T-1,
    built from iota in the trace."""
    n = config.rope_n_elem
    half = n // 2
    theta = clang.pow(float(config.rope_base), clang.true_divide(
        clang.mul(clang.arange(0, half, 1, device=device, dtype=dtypes.float32), -2.0), float(n)))
    pos = clang.arange(offset, offset + T, 1, device=device, dtype=dtypes.float32)
    freqs = clang.mul(clang.unsqueeze(pos, 1), clang.unsqueeze(theta, 0))  # (T, half)
    emb = clang.cat([freqs, freqs], dim=1)  # (T, n) rotate-half convention
    return clang.maybe_convert_to_dtype(clang.cos(emb), dtype), clang.maybe_convert_to_dtype(clang.sin(emb), dtype)


def _apply_rope(x, cos, sin, config: GPTConfig):
    """x: (B, H, T, hs). A composite op, so the rope kernel claims it whole."""
    return ttorch.apply_rope(x, cos, sin)


def _attention(x, p, cos, sin, config: GPTConfig, tp=None, sp=None):
    B, T, C = x.shape
    H, G, hs = config.n_head, config.query_groups, config.head_size

    if tp is not None and tp.split_on(p, "qkv_w", 0):
        # A block of qkv's rows holds no whole heads (q, k, v are laid out
        # one after another): the blocks are gathered before the head split.
        qkv = tp.gather(ttorch.linear(tp.enter(x), tp.block(p, "qkv_w", 0), tp.block(p, "qkv_b", 0)), 2)
    else:
        qkv = ttorch.linear(x, p["qkv_w"], p.get("qkv_b"))  # (B, T, (H+2G)*hs)
    q = qkv[..., : H * hs]
    k = qkv[..., H * hs : (H + G) * hs]
    v = qkv[..., (H + G) * hs :]

    q = ttorch.permute(ttorch.reshape(q, (B, T, H, hs)), (0, 2, 1, 3))  # (B,H,T,hs)
    k = ttorch.permute(ttorch.reshape(k, (B, T, G, hs)), (0, 2, 1, 3))
    v = ttorch.permute(ttorch.reshape(v, (B, T, G, hs)), (0, 2, 1, 3))

    q = _apply_rope(q, cos, sin, config)
    k = _apply_rope(k, cos, sin, config)

    if sp is not None:
        y = sp.attention(q, k, v, H, G)
    else:
        y = ttorch.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=(G != H))
    y = ttorch.reshape(ttorch.permute(y, (0, 2, 1, 3)), (B, T, H * hs))
    if tp is not None and tp.split_on(p, "proj_w", 1):
        return _bias(tp.exit(ttorch.linear(tp.split(y, 2), tp.block(p, "proj_w", 1))), p.get("proj_b"))
    return ttorch.linear(y, p["proj_w"], p.get("proj_b"))


def _bias(y, b):
    return y if b is None else y + b


def _moe_mlp(x, p, config: GPTConfig):
    """Mixtral-style MoE: top-k softmax routing over SwiGLU experts, dense
    per token at the trace level (every expert computed, top-k selected)."""
    B, T, C = x.shape
    k = config.n_expert_per_token
    xf = ttorch.reshape(x, (B * T, C))
    gate_logits = ttorch.linear(xf, p["router_w"])            # (N, E)
    top_logits, top_i = ttorch.topk(gate_logits, k, -1)       # (N, k)
    gate = ttorch.softmax(top_logits, -1)                     # renormalized over the k chosen
    h = ttorch.silu(ttorch.einsum("nd,ehd->neh", xf, p["w1"])) * ttorch.einsum(
        "nd,ehd->neh", xf, p["w3"]
    )
    all_out = ttorch.einsum("neh,edh->ned", h, p["w2"])       # (N, E, C)
    idx3 = ttorch.expand(ttorch.unsqueeze(top_i, -1), (B * T, k, C))
    sel = ttorch.take_along_dim(all_out, idx3, 1)             # (N, k, C)
    out = ttorch.sum(sel * ttorch.unsqueeze(gate, -1), 1)
    return ttorch.reshape(out, (B, T, C))


def _mlp(x, p, config: GPTConfig, tp=None):
    if config.mlp_class == "MoEMLP":
        return _moe_mlp(x, p, config)
    if tp is not None and tp.split_on(p, "proj_w", 1):
        # Column-parallel fc on this rank's block of the hidden units, the
        # activation on the block, row-parallel proj summed over tp.
        x = tp.enter(x)
        if config.mlp_class == "LLaMAMLP":
            h = ttorch.silu(ttorch.linear(x, tp.block(p, "fc_1_w", 0), tp.block(p, "fc_1_b", 0))) * ttorch.linear(
                x, tp.block(p, "fc_2_w", 0), tp.block(p, "fc_2_b", 0))
        else:
            h = ttorch.gelu(ttorch.linear(x, tp.block(p, "fc_w", 0), tp.block(p, "fc_b", 0)))
        return _bias(tp.exit(ttorch.linear(h, tp.block(p, "proj_w", 1))), p.get("proj_b"))
    if config.mlp_class == "LLaMAMLP":
        h = ttorch.silu(ttorch.linear(x, p["fc_1_w"], p.get("fc_1_b"))) * ttorch.linear(
            x, p["fc_2_w"], p.get("fc_2_b")
        )
        return ttorch.linear(h, p["proj_w"], p.get("proj_b"))
    h = ttorch.gelu(ttorch.linear(x, p["fc_w"], p.get("fc_b")))
    return ttorch.linear(h, p["proj_w"], p.get("proj_b"))


def _block(x, p, cos, sin, config: GPTConfig, tp=None, sp=None):
    n1 = _norm(x, p["norm_1"], config)
    attn_out = _attention(n1, p["attn"], cos, sin, config, tp, sp)
    if config.parallel_residual:
        n2 = n1 if config.shared_attention_norm else _norm(x, p["norm_2"], config)
        return x + attn_out + _mlp(n2, p["mlp"], config, tp)
    x = x + attn_out
    return x + _mlp(_norm(x, p["norm_2"], config), p["mlp"], config, tp)


def forward(params: dict, idx, config: GPTConfig, tp=None, sp=None):
    """Token ids (B, T) int → logits (B, T, padded_vocab_size)."""
    B, T = idx.shape
    x = ttorch.embedding(idx, params["wte"])  # (B, T, C)
    cos, sin = _rope_cache(T, config, device=x.device, dtype=x.dtype, offset=sp.offset(T) if sp is not None else 0)
    for p in params["blocks"]:
        x = _block(x, p, cos, sin, config, tp, sp)
    x = _norm(x, params["ln_f"], config)
    if tp is not None and tp.split_on(params, "lm_head_w", 0):
        # The vocab blocks of the logits are gathered, so that the CE
        # kernel sees whole rows.
        return tp.gather(ttorch.linear(tp.enter(x), tp.block(params, "lm_head_w", 0)), 2)
    return ttorch.linear(x, params["lm_head_w"])


def loss_fn(params: dict, idx, targets, config: GPTConfig, tp=None, sp=None):
    """Next-token cross-entropy; logits in f32 for a stable softmax."""
    logits = forward(params, idx, config, tp, sp)
    B, T, V = logits.shape
    logits = ttorch.reshape(logits.float(), (B * T, V))
    return ttorch.cross_entropy(logits, ttorch.reshape(targets, (B * T,)))
