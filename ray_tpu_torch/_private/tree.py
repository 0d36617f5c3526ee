"""Nested dicts, lists and tuples of tensors: the port's param trees."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """The tree with ``fn`` applied to each leaf, in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in a fixed order (dict keys sorted, as
    ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in tree_leaves(item)]
    return [tree]


def tree_from_numpy(tree: Any) -> Any:
    """A nested dict of numpy arrays (bf16 ones from ``ml_dtypes`` too) as
    CPU tensors of the same types, copied."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())
