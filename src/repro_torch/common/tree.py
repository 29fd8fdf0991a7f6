"""Tree utilities over the port's parameter trees (the port of
``repro.common.tree``): nested dicts, lists, tuples and NamedTuples of
tensors.

``leaves`` walks a tree in the reference's (``jax.tree_util``) order: dict
keys sorted, list and tuple items in order, NamedTuple fields in order,
None holding no leaf. ``tree_map`` rebuilds the first tree's structure,
visiting its leaves in that order too.
``global_norm`` adds the leaves' squared sums in that order, as the
reference's Python ``sum`` does.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    out = []
    for k in kids:
        out.extend(leaves(k))
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def count_params(tree) -> int:
    """Total number of scalar parameters in the tree."""
    return int(sum(int(np.prod(l.shape)) for l in leaves(tree)
                   if hasattr(l, "shape")))


def tree_bytes(tree) -> int:
    """Total bytes of the tree's tensors (and numpy arrays)."""
    total = 0
    for l in leaves(tree):
        if isinstance(l, torch.Tensor):
            total += l.numel() * l.element_size()
        elif hasattr(l, "shape") and hasattr(l, "dtype"):
            total += int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
    return total


def tree_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf is finite (no host sync)."""
    fl = [l for l in leaves(tree)
          if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not fl:
        return torch.tensor(True)
    out = torch.isfinite(fl[0]).all()
    for l in fl[1:]:
        out = out & torch.isfinite(l).all()
    return out


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over all leaves (gradient clipping); the squared sums
    are added in leaf order."""
    sq = None
    for l in leaves(tree):
        s = torch.sum(torch.square(l.to(torch.float32)))
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.tensor(0.0)
    return torch.sqrt(sq)
