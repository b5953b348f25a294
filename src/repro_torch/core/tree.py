"""Nested dict / list trees of tensors (the port's parameter, gradient and
optimizer-state trees) and the numpy round trip of their leaves.

``tree_leaves`` visits dict keys in sorted order, as ``jax.tree.leaves``
does, so sums over the leaves run in the reference's order where the two
trees have the same keys.  ``to_numpy`` / ``from_numpy`` carry bfloat16
(which numpy lacks) as its 16-bit pattern with the dtype's name, the
checkpoint store's on-disk form."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["tree_map", "tree_leaves", "tree_unflatten", "to_numpy", "from_numpy", "TORCH_DTYPES"]

# dtype names as numpy / ml_dtypes spell them -> torch dtypes
TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves, dict keys in sorted order (``jax.tree.leaves``'s)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree shaped like ``like`` whose leaves, in ``tree_leaves`` order,
    are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype name): bfloat16 and float8 as their bit patterns
    (uint16 / uint8 views), every other dtype as itself."""
    t = t.detach().cpu()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy(), name
    return t.numpy(), name


def from_numpy(a: np.ndarray, name: str, device) -> torch.Tensor:
    """The tensor of a host array and its dtype name (the inverse of
    ``to_numpy``; an ml_dtypes bfloat16 array is taken as well)."""
    a = np.require(a, requirements=["C", "W"])
    if name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif name.startswith("float8"):
        t = torch.from_numpy(a.view(np.uint8)).view(TORCH_DTYPES[name])
    else:
        t = torch.from_numpy(a)
    return t.to(device)
