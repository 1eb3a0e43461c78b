"""Parameter-tree utilities of the port (``repro.core.pytree``).

A "tree" here is a nested ``dict[str, ...]`` whose leaves are tensors; a
bare tensor is a tree of one leaf. :func:`leaves`, :func:`paths` and
:func:`unflatten` visit it in the order in which ``jax.tree`` flattens it:
every dict's keys sorted, list, tuple and NamedTuple items in order, and
``None`` (or an empty container) holding no leaf. So raveled matrices
have the reference's column order, and a checkpoint's leaves its file
order.
"""
from __future__ import annotations

import math

import torch


def _children(node):
    """A container's (key, child) pairs in ``jax.tree``'s order; None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree``'s order (module docstring)."""
    if tree is None:
        return []
    kids = _children(tree)
    return [tree] if kids is None else [x for _, v in kids for x in leaves(v)]


def paths(tree, prefix=()) -> list:
    """The key path of every leaf, in the order of :func:`leaves` (a list
    or tuple item's key is its index as a string)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [prefix]
    return [p for k, v in kids for p in paths(v, prefix + (k,))]


def unflatten(tree, values):
    """A tree of ``tree``'s structure whose leaves are ``values``, taken in
    the order of :func:`leaves`; ``None`` stays ``None``, and a NamedTuple
    its own type."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf (and the matching leaves of ``rest``, trees of
    the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def stack(trees, dim: int = 0):
    """Trees of one structure, stacked leaf by leaf on a new axis ``dim``.
    One tree is viewed with the new axis, not copied (a model's one layer
    group keeps a single copy of its weights)."""
    if len(trees) == 1:
        return tree_map(lambda x: x.unsqueeze(dim), trees[0])
    return tree_map(lambda *xs: torch.stack(xs, dim=dim), *trees)


def layer_views(tree, count: int):
    """Views of a (m, L, ...) stacked tree at each of its first ``count``
    indices of axis 1, one tree a layer (or layer group)."""
    for i in range(count):
        yield tree_map(lambda x, i=i: x[:, i], tree)


def stacked_ravel(tree, lead: int = 1, *, out=None) -> torch.Tensor:
    """Ravel a tree whose leaves share ``lead`` leading axes into a matrix.

    Leaves (L0,..,L_{lead-1}, ...) are flattened and concatenated on the
    last axis -> (L0,..,L_{lead-1}, d). With ``out`` (a tensor of shape
    (L0,..,L_{lead-1}, >= d), any strides), the leaves are copied into its
    first d columns, cast to its dtype, and ``out`` is returned; its
    columns past d are left as they are (a zero-tailed, 128-aligned buffer
    stays zero-tailed), and no (…, d) concatenation is made.
    """
    ls = leaves(tree)
    head = tuple(ls[0].shape[:lead])
    if out is None:
        return torch.cat([x.reshape(head + (-1,)) for x in ls], dim=-1)
    if tuple(out.shape[:-1]) != head:
        raise ValueError(f"stacked_ravel: out {tuple(out.shape)} does not lead with {head}")
    sizes = [x.numel() // max(1, math.prod(head)) for x in ls]
    if sum(sizes) > out.shape[-1]:
        raise ValueError(f"stacked_ravel: out is {out.shape[-1]} columns wide, the tree "
                         f"needs {sum(sizes)}")
    off = 0
    for x, size in zip(ls, sizes):
        out[..., off: off + size].copy_(x.reshape(head + (size,)))
        off += size
    return out


def tree_count_params(tree) -> int:
    return sum(int(x.numel()) for x in leaves(tree))
