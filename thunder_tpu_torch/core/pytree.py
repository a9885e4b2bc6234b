"""Pytree flatten/unflatten.

Reference parity: thunder/core/pytree.py, which wraps the external C++
``optree``. Here the tree library is PyTorch's own ``torch.utils._pytree``.
Proxies are leaves (unregistered types are leaves). Dicts flatten in
insertion order, so every flatten of one structure gives one leaf order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch.utils._pytree as _pt

tree_flatten = _pt.tree_flatten
tree_unflatten = _pt.tree_unflatten
tree_map = _pt.tree_map
tree_leaves = _pt.tree_leaves
tree_structure = _pt.tree_structure


def tree_flatten_with_dataclass(x: Any):
    return _pt.tree_flatten(x)


def tree_map_only(typ, fn: Callable, tree: Any) -> Any:
    return _pt.tree_map(lambda v: fn(v) if isinstance(v, typ) else v, tree)
