"""The GPT-NeoX family (``model_type`` "gpt_neox" in a configuration file).

What the harness needs of a family: its sizes (:func:`dims`), the layout and
initial scale of its weights (:func:`layout`), the program's configuration for
it (:func:`program_config`, the only function here that imports the program),
and its plain reference (:data:`REFERENCE`, a module under ``reference/``).

The weights are a nested dict in the layout the port's ``models/gpt.py``
reads; the reference reads the same dict. The fused qkv weight holds all query
heads, then all key heads, then all value heads.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

REFERENCE = "neox"


def dims(c: dict) -> SimpleNamespace:
    d, H, L = c["hidden_size"], c["num_attention_heads"], c["num_hidden_layers"]
    F, V = c["intermediate_size"], c["vocab_size"]
    per_layer = (3 * d * d + 3 * d) + (d * d + d) + (F * d + F) + (d * F + d) + 4 * d
    return SimpleNamespace(
        hidden=d, heads=H, head_size=d // H, layers=L, ffn=F, vocab=V,
        max_len=c["max_position_embeddings"],
        n_params=V * d + L * per_layer + 2 * d + V * d,
        n_embedding=V * d,
    )


def layout(c: dict) -> dict:
    """The weights as a nested dict of ``(shape, init)`` leaves. ``init`` is
    ``("normal", std)`` or ``("one_plus", std)`` (1 + std·N(0, 1))."""
    d, F, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    std = c["initializer_range"]
    out_std = std / math.sqrt(2 * L)

    def norm():
        return {"weight": ((d,), ("one_plus", std)), "bias": ((d,), ("normal", std))}

    def block():
        return {
            "norm_1": norm(),
            "attn": {"qkv_w": ((3 * d, d), ("normal", std)), "proj_w": ((d, d), ("normal", out_std)),
                     "qkv_b": ((3 * d,), ("normal", std)), "proj_b": ((d,), ("normal", std))},
            "mlp": {"fc_w": ((F, d), ("normal", std)), "proj_w": ((d, F), ("normal", out_std)),
                    "fc_b": ((F,), ("normal", std)), "proj_b": ((d,), ("normal", std))},
            "norm_2": norm(),
        }

    return {"wte": ((V, d), ("normal", std)), "blocks": [block() for _ in range(L)], "ln_f": norm(),
            "lm_head_w": ((V, d), ("normal", std))}


def units(c: dict, path: str, leaf) -> list:
    """The parameters a leaf holds, for comparing them one by one. The fused
    qkv weight is three, the query, key and value projections; the qkv bias
    is four: the query's, the key's on the features that take the rotary
    embedding, the key's on the features that pass through it, and the
    value's. The last key part adds the same to every score of a query, so
    softmax gives it no gradient and it moves by round-off alone. Every
    other leaf is one."""
    if path.endswith("qkv_w"):
        return [(f"{path}.{n}", part) for n, part in zip("qkv", leaf.chunk(3, dim=0))]
    if path.endswith("qkv_b"):
        H = c["num_attention_heads"]
        hs = c["hidden_size"] // H
        rot = int(c["rotary_pct"] * hs)
        q, k, v = leaf.chunk(3, dim=0)
        k = k.reshape(H, hs)
        return [(f"{path}.q", q), (f"{path}.k_rotary", k[:, :rot]), (f"{path}.k_passed", k[:, rot:]),
                (f"{path}.v", v)]
    return [(path, leaf)]


def program_config(name: str, c: dict):
    """The port's ``GPTConfig`` for this configuration."""
    from thunder_tpu_torch.models.gpt import GPTConfig

    if c["hidden_act"] != "gelu" or c["tie_word_embeddings"]:
        raise ValueError(f"{name}: the port's GPT-NeoX has an exact GELU and an untied head")
    return GPTConfig(
        name=name, block_size=c["max_position_embeddings"], vocab_size=c["vocab_size"],
        padded_vocab_size=c["vocab_size"], n_layer=c["num_hidden_layers"], n_head=c["num_attention_heads"],
        n_embd=c["hidden_size"], rotary_percentage=c["rotary_pct"], parallel_residual=c["use_parallel_residual"],
        bias=True, norm_class="LayerNorm", norm_eps=c["layer_norm_eps"], mlp_class="GptNeoxMLP",
        intermediate_size=c["intermediate_size"], rope_base=c["rotary_emb_base"],
    )
