"""Sharding plans for the GPT params, and the blocks each rank holds.

The counterpart of ``thunder_tpu/parallel/sharding.py``: the same specs,
leaf for leaf (``distributed.runtime.P`` in the seat of
``jax.sharding.PartitionSpec``):

- **FSDP** (ZeRO): a weight is split over the ``fsdp`` axis on its
  compute-free dim (on the other when that does not divide);
- **TP** (Megatron): the qkv and fc projections column-parallel (rows over
  ``tp``), the output projections row-parallel (columns over ``tp``), the
  embedding and the head vocab-parallel;
- **DP**: the batch of the tokens over ``(dp, fsdp)`` together.

In the JAX package a spec lays out a ``jax.Array`` that XLA's partitioner
then computes on. In the port each rank holds its block of each leaf
(:func:`shard_pytree`) and the sharded training step
(``parallel/train.py``) places the collectives itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from thunder_tpu_torch.distributed.runtime import P
from thunder_tpu_torch.models.gpt import GPTConfig


def _P(*parts) -> P:
    return P(*parts)


def _sizes(mesh) -> dict:
    """``{axis: size}`` of a mesh, a ``MeshConfig`` or None (all 1)."""
    from thunder_tpu_torch.parallel.mesh import MeshConfig, axis_sizes

    if mesh is None:
        return {}
    if isinstance(mesh, MeshConfig):
        return mesh.axis_sizes()
    return axis_sizes(mesh)


def _axis(mesh, name: str) -> Optional[str]:
    """Axis name if present in the mesh with size > 1, else None."""
    return name if _sizes(mesh).get(name, 1) > 1 else None


def _div(n: int, axis_size: int) -> bool:
    return axis_size > 0 and n % axis_size == 0


def gpt_param_specs(config: GPTConfig, mesh, *, fsdp: bool = True, tp: bool = True) -> dict:
    """``P`` pytree matching ``models.gpt.init_params``'s structure.
    ``mesh`` is a :class:`~thunder_tpu_torch.parallel.mesh.Mesh` or a
    ``MeshConfig`` (the specs depend only on the axis sizes)."""
    fs = _axis(mesh, "fsdp") if fsdp else None
    tpx = _axis(mesh, "tp") if tp else None
    sizes = _sizes(mesh)
    fs_n = sizes.get("fsdp", 1)
    tp_n = sizes.get("tp", 1)

    C = config

    def spec2d(rows: int, cols: int, *, col_parallel: Optional[bool]):
        """(rows, cols) weight: TP on the compute-parallel dim, FSDP on the
        other (or on rows when no TP)."""
        row_ax = col_ax = None
        if col_parallel is True and tpx and _div(rows, tp_n):
            row_ax = tpx
        elif col_parallel is False and tpx and _div(cols, tp_n):
            col_ax = tpx
        if fs:
            if row_ax is None and _div(rows, fs_n):
                row_ax = (row_ax, fs) if row_ax else fs
            elif col_ax is None and _div(cols, fs_n):
                col_ax = fs
        return _P(row_ax, col_ax)

    def norm_spec(p: dict) -> dict:
        return {k: _P(None) for k in p}

    def block_spec(blk: dict) -> dict:
        s: dict[str, Any] = {
            "norm_1": norm_spec(blk["norm_1"]),
            "attn": {},
            "mlp": {},
        }
        if "norm_2" in blk:
            s["norm_2"] = norm_spec(blk["norm_2"])
        a = blk["attn"]
        s["attn"]["qkv_w"] = spec2d(C.qkv_out, C.n_embd, col_parallel=True)
        s["attn"]["proj_w"] = spec2d(C.n_embd, C.n_head * C.head_size, col_parallel=False)
        if "qkv_b" in a:
            s["attn"]["qkv_b"] = _P(tpx if tpx and _div(C.qkv_out, tp_n) else None)
        if "proj_b" in a:
            s["attn"]["proj_b"] = _P(None)
        mlp = blk["mlp"]
        hidden = C.mlp_hidden
        if "fc_1_w" in mlp:
            s["mlp"]["fc_1_w"] = spec2d(hidden, C.n_embd, col_parallel=True)
            s["mlp"]["fc_2_w"] = spec2d(hidden, C.n_embd, col_parallel=True)
            s["mlp"]["proj_w"] = spec2d(C.n_embd, hidden, col_parallel=False)
        if "fc_w" in mlp:
            s["mlp"]["fc_w"] = spec2d(hidden, C.n_embd, col_parallel=True)
            s["mlp"]["proj_w"] = spec2d(C.n_embd, hidden, col_parallel=False)
        for b_name in ("fc_1_b", "fc_2_b", "fc_b"):
            if b_name in mlp:
                s["mlp"][b_name] = _P(tpx if tpx and _div(hidden, tp_n) else None)
        if "proj_b" in mlp:
            s["mlp"]["proj_b"] = _P(None)
        return s

    # Embedding / head: vocab-parallel over tp, fsdp on the other dim.
    return {
        "wte": spec2d(C.padded_vocab_size, C.n_embd, col_parallel=True),
        "blocks": [block_spec(b) for b in _blocks_template(config)],
        "ln_f": {"weight": _P(None), **({"bias": _P(None)} if C.norm_class == "LayerNorm" else {})},
        "lm_head_w": spec2d(C.padded_vocab_size, C.n_embd, col_parallel=True),
    }


def _blocks_template(config: GPTConfig) -> list[dict]:
    """Structure-only template of one block's param dict (no tensors)."""
    blk: dict[str, Any] = {
        "norm_1": {"weight": 0, **({"bias": 0} if config.norm_class == "LayerNorm" else {})},
        "attn": {"qkv_w": 0, "proj_w": 0, **({"qkv_b": 0, "proj_b": 0} if config.bias else {})},
        "mlp": {},
    }
    if not config.shared_attention_norm:
        blk["norm_2"] = dict(blk["norm_1"])
    if config.mlp_class == "LLaMAMLP":
        blk["mlp"] = {"fc_1_w": 0, "fc_2_w": 0, "proj_w": 0}
        if config.bias:
            blk["mlp"].update({"fc_1_b": 0, "fc_2_b": 0, "proj_b": 0})
    else:
        blk["mlp"] = {"fc_w": 0, "proj_w": 0}
        if config.bias:
            blk["mlp"].update({"fc_b": 0, "proj_b": 0})
    return [blk for _ in range(config.n_layer)]


def data_spec(mesh) -> P:
    """Batch sharding for (B, T) token tensors: batch over (dp, fsdp)."""
    batch_axes = tuple(a for a in ("dp", "fsdp") if _axis(mesh, a))
    seq_ax = _axis(mesh, "sp")
    return _P(batch_axes if batch_axes else None, seq_ax)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``'s seat)."""

    mesh: Any
    spec: P


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _flat_specs(specs) -> list:
    from thunder_tpu_torch.core.pytree import tree_flatten

    return tree_flatten(specs, is_leaf=_is_spec)[0] if not _is_spec(specs) else [specs]


def named_shardings(mesh, specs):
    """The spec tree with each ``P`` bound to ``mesh``."""
    from thunder_tpu_torch.core.pytree import tree_map

    return tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=_is_spec)


def align_specs(specs, tree):
    """``specs`` in ``tree``'s structure and order: dicts matched by key
    (a spec tree need not list its keys in the params' order), a ``P``
    standing for a whole subtree."""
    if _is_spec(specs) or specs is None:
        return specs
    if isinstance(tree, dict):
        return {k: align_specs(specs[k], v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(align_specs(s, v) for s, v in zip(specs, tree))
    return specs


def shard_pytree(tree, mesh, specs):
    """This rank's block of each leaf of ``tree`` (the whole values, the same
    on every rank) by its spec: a copy of the block for a split leaf, the
    leaf itself for a replicated one. The ``device_put`` onto a mesh of the
    JAX package, where each device keeps its block."""
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
    from thunder_tpu_torch.distributed import runtime

    flat, struct = tree_flatten(tree)
    flat_specs = _flat_specs(align_specs(specs, tree))
    if len(flat_specs) != len(flat):
        raise ValueError(f"specs have {len(flat_specs)} leaves, the tree {len(flat)}")
    groups = _groups(mesh, flat_specs)
    out = [runtime.split(x, s, groups).clone() if s is not None and s.axes else x for x, s in zip(flat, flat_specs)]
    return tree_unflatten(out, struct)


def _groups(mesh, flat_specs) -> dict:
    from thunder_tpu_torch.distributed import runtime

    axes = sorted({ax for s in flat_specs if s is not None for ax in s.axes})
    return runtime.resolve_axes(mesh, axes) if axes else {}


def gather_pytree(tree, mesh=None, specs=None):
    """Every leaf whole: the blocks of a leaf that ``specs`` splits
    all-gathered over ``mesh``'s groups (``distributed/checkpoint.gather_full``),
    the mesh-independent intermediate of a reshard. Each rank gets the
    whole tree, on the device its blocks are on."""
    from thunder_tpu_torch.distributed.checkpoint import gather_full

    return gather_full(tree, mesh=mesh, specs=align_specs(specs, tree))


def reshard_pytree(tree, mesh, specs, *, src_mesh=None, src_specs=None):
    """Re-lay-out a pytree of blocks, held by ``src_specs`` over
    ``src_mesh``, onto ``specs`` over ``mesh`` (which may have another
    shape): gather (:func:`gather_pytree`), then :func:`shard_pytree`. The
    values keep their bits; only the layout changes. A JAX array carries its
    own layout; a rank's block does not, hence ``src_mesh``/``src_specs``
    (default: the target's)."""
    src_mesh = mesh if src_mesh is None else src_mesh
    src_specs = specs if src_specs is None else src_specs
    return shard_pytree(gather_pytree(tree, src_mesh, src_specs), mesh, specs)
