"""Sequence (context) parallelism: ring attention and Ulysses (all-to-all).

The counterpart of ``thunder_tpu/parallel/context.py``:

- **Ring attention** (:func:`ring_attention`): K/V blocks rotate around the
  ``sp`` ring by ``ppermute`` while each rank merges online-softmax partial
  results for its own Q block; peak memory a rank is O(S_local²) scores.
- **Ulysses** (:func:`ulysses_attention`): all-to-all from seq-sharded to
  head-sharded, attention over the whole sequence for a head group, and
  all-to-all back.

Both are functions of the torch language plus the ``ppermute``/``all_to_all``
prims, so a program that calls them is traced, claimed and differentiated
(``grad_transform``, with the prims' VJP rules) like any other, where the
JAX package has ``jax.grad``. The axis size and this rank's index
(``lax.psum(1, axis)``, ``lax.axis_index``) are numbers read from the group
bound to the axis when the rank traces its program
(``distributed.runtime.axis_size``/``axis_index``): each rank traces its own
program, the ring unrolled. At an axis of size 1 no collective is placed.

The blocks are plain products in f32, as the JAX package's ``_block_attn``
(``jnp.einsum``) is, not the flash kernel; a flash block with an lse merge
would not change a result and is later work.
"""

from __future__ import annotations

import math
from typing import Optional

import thunder_tpu_torch.torch as ttorch


def _block_attn(q, k, v, *, scale, q_offset, k_offset, causal):
    """One (S_q_local, S_k_local) attention block with global-position
    causal masking. Returns (o_unnormalized, m, l) for online-softmax
    merging. A row whose keys are all in its future keeps a finite max and
    zero weights (``m_safe`` and the ``isfinite`` select), so the first ring
    step of a later rank gives no NaN."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = ttorch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        Sq, Sk = q.shape[-2], k.shape[-2]
        qpos = ttorch.unsqueeze(ttorch.arange(q_offset, q_offset + Sq, device=q.device), 1)
        kpos = ttorch.unsqueeze(ttorch.arange(k_offset, k_offset + Sk, device=q.device), 0)
        s = ttorch.where(qpos >= kpos, s, float("-inf"))
    m = ttorch.amax(s, -1, keepdim=True)  # (B, H, Sq, 1)
    m_safe = ttorch.where(ttorch.isfinite(m), m, 0.0)  # fully masked rows
    p = ttorch.exp(s - m_safe)
    p = ttorch.where(ttorch.isfinite(s), p, 0.0)
    l = ttorch.sum(p, -1, keepdim=True)
    o = ttorch.einsum("bhqk,bhkd->bhqd", p, vf)
    return o, m_safe, l


def _normalize(o, l, dtype):
    """The merged output divided by its softmax denominator."""
    return (o / ttorch.clamp(l, min=1e-30)).to(dtype)


def ring_attention(q, k, v, axis_name: str, *, causal: bool = True, scale: Optional[float] = None):
    """Causal attention with the sequence split over the mesh axis
    ``axis_name``: q/k/v are this rank's (B, H, S_local, D) blocks (rank i
    holds positions i·S_local onwards); the output matches q.

    K/V rotate one ring hop a step; each rank merges the incoming block's
    contribution into its running (out, max, denominator) accumulator, the
    online softmax of flash attention lifted to the ring. The accumulator
    starts from the first block, which equals the JAX package's merge into
    (0, −inf, 0) bit for bit."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed import runtime

    n = runtime.axis_size(axis_name)
    my = runtime.axis_index(axis_name)
    S_local, D = q.shape[-2], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ring = [(i, (i + 1) % n) for i in range(n)]

    k_cur, v_cur = k, v
    o_acc = m_acc = l_acc = None
    for step in range(n):
        src = (my - step) % n  # the global block k_cur/v_cur hold
        o, m, l = _block_attn(q, k_cur, v_cur, scale=scale, q_offset=my * S_local, k_offset=src * S_local,
                              causal=causal)
        if o_acc is None:
            o_acc, m_acc, l_acc = o, m, l
        else:
            m_new = ttorch.maximum(m_acc, m)
            alpha = ttorch.exp(m_acc - m_new)  # rescale the old accumulator
            beta = ttorch.exp(m - m_new)  # rescale the new block
            o_acc = o_acc * alpha + o * beta
            l_acc = l_acc * alpha + l * beta
            m_acc = m_new
        if step + 1 < n:
            k_cur = dist.ppermute(k_cur, axis_name, ring)
            v_cur = dist.ppermute(v_cur, axis_name, ring)
    return _normalize(o_acc, l_acc, q.dtype)


def ulysses_attention(q, k, v, axis_name: str, *, causal: bool = True, scale: Optional[float] = None):
    """DeepSpeed-Ulysses sequence parallelism: all-to-all from seq-sharded
    (B, H, S/p, D) to head-sharded (B, H/p, S, D), attention over the whole
    sequence, then all-to-all back. H must divide by the axis size.

    The JAX package's ``tiled=False`` all-to-alls become the port's tiled
    prim on a reshaped tensor: the sequence comes back block-major (source
    rank, then position) and the heads group-major (rank, then head)."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed import runtime

    n = runtime.axis_size(axis_name)
    B, H, S_local, D = q.shape
    if H % n:
        raise ValueError(f"ulysses_attention: {H} heads do not split over the {n} ranks of axis {axis_name!r}")

    def to_head_sharded(x):
        # (B, H, S/p, D) -> (B, p, H/p, S/p, D): head group g goes to rank g,
        # and rank r's sequence block lands at block r of dim 3.
        if n == 1:
            return x
        x = ttorch.reshape(x, (B, n, H // n, S_local, D))
        x = dist.all_to_all(x, axis_name, n, split_dim=1, concat_dim=3)
        return ttorch.reshape(x, (B, H // n, n * S_local, D))

    def to_seq_sharded(x):
        # (B, H/p, S, D) -> (B, H, S/p, D): sequence block r goes to rank r,
        # and rank g's head group lands at group g of the heads.
        if n == 1:
            return x
        return dist.all_to_all(x, axis_name, n, split_dim=2, concat_dim=1)

    qh, kh, vh = to_head_sharded(q), to_head_sharded(k), to_head_sharded(v)
    o, _, l = _block_attn(qh, kh, vh, scale=scale if scale is not None else 1.0 / math.sqrt(D),
                          q_offset=0, k_offset=0, causal=causal)
    return to_seq_sharded(_normalize(o, l, q.dtype))


__all__ = ["ring_attention", "ulysses_attention"]
