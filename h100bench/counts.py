"""Operation and byte counts of the work the inputs need, from shapes.

The yardstick's own arithmetic, after ``thunder_tpu_torch/benchmarks/__init__.py``
(6·N a trained token, 2·N a scored one) and ``thunder_tpu_torch/analysis/cost.py``
(a kernel's bound is the larger of its operations at the peak rate and its bytes
at the memory rate), kept here so that no change to the program moves it.

- Attention is counted at the head size as given (not padded to a kernel's
  bucket), and causal attention as the lower triangle with its diagonal:
  T·(T+1)/2 query-key pairs a head. The forward is two products over those
  pairs (scores, then the weighted sum of values); the backward is four (dV,
  dP, dQ, dK) and counts no recomputation. Bytes: each input read once and each
  output written once, in the activations' type; the forward reads q, k, v and
  writes o; the backward reads q, k, v, o and dO and writes dq, dk, dv.
- A model's FLOPs exclude the input embedding (a lookup, not a product): a
  trained token costs 6·(N − embedding) plus its attention, a scored one
  2·(N − embedding) plus its attention.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak(device_name: str):
    """The table's entry for a card, matched by name, or None."""
    for key, entry in PEAKS.items():
        if key in device_name:
            return entry
    return None


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def attention_fwd_flops(B: int, H: int, T: int, D: int) -> int:
    return 4 * B * H * D * causal_pairs(T)


def attention_bwd_flops(B: int, H: int, T: int, D: int) -> int:
    return 2 * attention_fwd_flops(B, H, T, D)


def attention_fwd_bytes(B: int, H: int, T: int, D: int, itemsize: int = 2) -> int:
    return 4 * B * H * T * D * itemsize


def attention_bwd_bytes(B: int, H: int, T: int, D: int, itemsize: int = 2) -> int:
    return 8 * B * H * T * D * itemsize


def bound_s(flops: float, nbytes: float, peak_flops: float, peak_bytes_per_s: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes_per_s)


def attention_bound_s(dims, B: int, T: int, peak_entry: dict, backward: bool) -> float:
    """The bound of one model's attention over all its layers for a (B, T)
    batch: the forward, plus the backward when ``backward``."""
    H, D, L = dims.heads, dims.head_size, dims.layers
    pf, pb = peak_entry["bf16_flops"], peak_entry["hbm_bytes_per_s"]
    s = bound_s(attention_fwd_flops(B, H, T, D), attention_fwd_bytes(B, H, T, D), pf, pb)
    if backward:
        s += bound_s(attention_bwd_flops(B, H, T, D), attention_bwd_bytes(B, H, T, D), pf, pb)
    return L * s


def train_flops(dims, B: int, T: int) -> int:
    """Model FLOPs of one training step on a (B, T) batch."""
    L, H, D = dims.layers, dims.heads, dims.head_size
    attn = attention_fwd_flops(B, H, T, D) + attention_bwd_flops(B, H, T, D)
    return 6 * (dims.n_params - dims.n_embedding) * B * T + L * attn


def forward_flops(dims, B: int, T: int) -> int:
    """Model FLOPs of one forward (with its loss) on a (B, T) batch."""
    L, H, D = dims.layers, dims.heads, dims.head_size
    return 2 * (dims.n_params - dims.n_embedding) * B * T + L * attention_fwd_flops(B, H, T, D)
