"""Helpers for nested dicts/lists of tensors, and numpy interchange.

The port keeps parameters and caches as nested dicts and lists, the shape
of the JAX package's pytrees.  Names are the JAX pytree paths that
``repro.statestore.checkpoint.flatten_named`` produces (dict keys in
sorted order, list indices as numbers: ``blocks/0/l0/mixer/wq``), so
weights and store versions carry across the two packages.

bfloat16 crosses into numpy as ``uint16`` bits, as the store keeps it on
disk; a numpy array whose dtype is named ``bfloat16`` (``ml_dtypes``) is
recognised by that name, without importing ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Tree = Any


def _join(prefix: str, key: Any) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_map_named(fn: Callable[[str, Any], Any], tree: Tree,
                   is_leaf: Callable[[Any], bool] = None, prefix: str = "") -> Tree:
    """Applies `fn(name, leaf)` to every leaf, keeping the dict/list
    structure; None subtrees stay None."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, is_leaf, _join(prefix, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_named(fn, v, is_leaf, _join(prefix, i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree: Tree, is_leaf: Callable[[Any], bool] = None) -> Tree:
    """Applies `fn` to every leaf, keeping the dict/list structure."""
    return tree_map_named(lambda _, leaf: fn(leaf), tree, is_leaf)


def flatten_named(tree: Tree, is_leaf: Callable[[Any], bool] = None) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flattening order: dict keys sorted, list
    items in order; None subtrees are empty."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [("", tree)]
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("", tree)]
    return [(_join(str(k), name) if name else str(k), leaf)
            for k, child in items for name, leaf in flatten_named(child, is_leaf)]


def dtype_name(x: Any) -> str:
    """numpy-style name of a tensor's or array's dtype ("bfloat16", "float32", ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def to_numpy(x: Any) -> np.ndarray:
    """A CPU numpy copy of a tensor or array; bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def from_numpy(arr: np.ndarray, dtype: str = None) -> torch.Tensor:
    """A CPU tensor from a numpy array.  `dtype="bfloat16"` reads the array
    as bfloat16 bits (uint16, or an ``ml_dtypes`` bfloat16 array)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        dtype, arr = "bfloat16", arr.view(np.uint16)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr).copy()
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 needs 16-bit words, got {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
