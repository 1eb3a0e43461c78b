"""Parameter-tree utilities of the port.

A params "tree" here is a flat ``dict[str, Tensor]``. Its leaves are always
visited in sorted-key order, the order in which ``jax.tree`` flattens a
dict, so raveled matrices have the reference's column order.
"""
from __future__ import annotations

import torch


def leaves(tree: dict) -> list:
    """The leaves of a params dict in sorted-key (reference) order."""
    return [tree[k] for k in sorted(tree)]


def stacked_ravel(tree: dict, lead: int = 1) -> torch.Tensor:
    """Ravel a tree whose leaves share ``lead`` leading axes into a matrix.

    Leaves (L0,..,L_{lead-1}, ...) are flattened and concatenated on the
    last axis -> (L0,..,L_{lead-1}, d).
    """
    ls = leaves(tree)
    head = tuple(ls[0].shape[:lead])
    return torch.cat([x.reshape(head + (-1,)) for x in ls], dim=-1)


def tree_count_params(tree: dict) -> int:
    return sum(int(x.numel()) for x in tree.values())
