"""Mixture-of-Experts with expert parallelism over an ``ep`` mesh axis.

The counterpart of ``thunder_tpu/parallel/moe.py``:

- the experts are split over ``ep``: each rank holds ``E / ep`` experts'
  weights;
- tokens are routed top-k by a learned router and packed into
  per-(source rank, expert) capacity slots by one-hot dispatch einsums (no
  data-dependent shapes; a token over the capacity is dropped), sent to the
  ranks that own their experts with one tiled ``all_to_all``, transformed by
  the local experts as one batched einsum, and sent back by the reverse
  ``all_to_all``; the combine einsum applies the router weights.

Both functions are programs of the torch language and the ``all_to_all``
prim, so ``grad_transform`` gives the grads of the router and of both expert
weights, through the two shuffles (the prim's VJP is the tiled transpose).
The axis size is read from the group bound to the axis when the rank traces
(``distributed.runtime.axis_size``); at one rank no collective is placed.
With a capacity that drops no token the result is the dense
``Σ_k p_k · expert_{i_k}(x)`` of :func:`moe_mlp_dense_reference`.

As in the JAX package, the default activation is ``jax.nn.gelu``'s: the tanh
approximation (``gelu(approximate="tanh")``, not torch's erf default); a
slot index at or past the capacity one-hots to a zero row (``one_hot``
compares with an ``arange``), which is how a dropped token vanishes.
"""

from __future__ import annotations

from typing import Optional

import thunder_tpu_torch.torch as ttorch


def _gelu_tanh(x):
    return ttorch.gelu(x, approximate="tanh")


def _route(xf, router_w, top_k: int):
    """(top_p, top_i), each (n, k): the router's top-k probabilities over
    f32 tokens and their experts."""
    return ttorch.topk(ttorch.softmax(ttorch.matmul(xf, router_w.float()), -1), top_k, -1)


def _one_hot(idx, n: int):
    return ttorch.one_hot(idx, n).float()


def dispatch_plan(xf, router_w, n_expert: int, top_k: int, capacity: int):
    """(dispatch, combine), each (n, E, C): the slot of each (token,
    choice) in its expert's capacity, taken in token order, as a one-hot
    (dispatch, in {0, 1}) and weighted by the router's probability
    (combine); a choice whose slot is at or past ``capacity`` is dropped.
    ``dispatch.sum()`` is the count of assignments kept."""
    n = xf.shape[0]
    top_p, top_i = _route(xf, router_w, top_k)
    choice_mask = _one_hot(top_i, n_expert)  # (n, k, E)
    flat_mask = ttorch.reshape(choice_mask, (n * top_k, n_expert))
    pos = ttorch.cumsum(flat_mask, 0) - flat_mask
    pos = ttorch.reshape(pos * flat_mask, (n, top_k, n_expert))
    keep = (pos < capacity).float() * choice_mask
    slot_oh = _one_hot(pos.long(), capacity)  # (n, k, E, C)
    dispatch = ttorch.sum(slot_oh * ttorch.unsqueeze(keep, -1), 1)
    combine = ttorch.sum(slot_oh * ttorch.unsqueeze(keep * ttorch.unsqueeze(top_p, -1), -1), 1)
    return dispatch, combine


def moe_mlp(x, router_w, w1, w2, axis_name: str, *, top_k: int = 2, capacity: Optional[int] = None,
            activation=None):
    """Expert-parallel MoE MLP for this rank's token block.

    x: (n, d) this rank's tokens; router_w: (d, E) replicated, E the total
    expert count; w1: (E_local, d, h) and w2: (E_local, h, d) this rank's
    experts (rank g holds experts g·E_local onwards). ``capacity``: the slot
    count C a (source rank, expert), default n (no token is ever dropped).
    Returns (n, d), the router-weighted expert outputs, in x's dtype."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed import runtime

    n = x.shape[0]
    e_local = w1.shape[0]
    ep = runtime.axis_size(axis_name)
    E = e_local * ep
    C = int(capacity) if capacity is not None else n
    act = activation if activation is not None else _gelu_tanh

    xf = x.float()
    dispatch, combine = dispatch_plan(xf, router_w, E, top_k, C)

    # Rank m's sent[g·E_local + l] holds its tokens for rank g's expert l;
    # the tiled all_to_all splits dim 0 over the ranks and concatenates what
    # each receives along dim 1: recv[l, m·C + c] = rank m's slot c.
    sent = ttorch.einsum("nd,nec->ecd", xf, dispatch)  # (E, C, d)
    recv = dist.all_to_all(sent, axis_name, ep, split_dim=0, concat_dim=1) if ep > 1 else sent

    h = act(ttorch.einsum("ecd,edh->ech", recv, w1.float()))
    y = ttorch.einsum("ech,ehd->ecd", h, w2.float())  # (E_local, ep·C, d)

    # The return trip (the transposed shuffle), then the combine.
    back = dist.all_to_all(y, axis_name, ep, split_dim=1, concat_dim=0) if ep > 1 else y  # (E, C, d)
    out = ttorch.einsum("ecd,nec->nd", back, combine)
    return out.to(x.dtype)


def moe_mlp_dense_reference(x, router_w, w1_full, w2_full, *, top_k: int = 2, activation=None):
    """The oracle: per token the dense Σ_k p_k · expert_{i_k}(x) with the
    whole (unsplit) expert weights, every expert computed on every token.
    What :func:`moe_mlp` computes when no token is dropped."""
    act = activation if activation is not None else _gelu_tanh
    xf = x.float()
    top_p, top_i = _route(xf, router_w, top_k)
    h = act(ttorch.einsum("nd,edh->neh", xf, w1_full.float()))
    all_out = ttorch.einsum("neh,ehd->ned", h, w2_full.float())  # (n, E, d)
    n, _, d = all_out.shape
    idx = ttorch.expand(ttorch.unsqueeze(top_i, -1), (n, top_k, d))
    sel = ttorch.take_along_dim(all_out, idx, 1)  # (n, k, d)
    return ttorch.sum(sel * ttorch.unsqueeze(top_p, -1), 1).to(x.dtype)


__all__ = ["dispatch_plan", "moe_mlp", "moe_mlp_dense_reference"]
