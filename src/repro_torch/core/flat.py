"""Static layout table for the flat-slab client state.

All client state is ONE float32 ``(m, dim_aligned)`` matrix, the *slab*.
:class:`LayoutTable` is built once from the ``params0`` template, a
nested dict of tensors (a LeNet's flat dict, or a transformer's nested
one), and records, per leaf in sorted-key order at every level (the
reference's ``jax.tree`` order), the trailing shape, dtype, flat size and
column offset;
``dim_aligned`` rounds the width up to the 128 multiple
(:func:`repro_torch.kernels.ops.aligned_dim`) and the tail columns are zero.

``ravel`` accepts any leading shape and copies; ``unravel`` returns leaves
that are views into the matrix where the dtype allows (float32 leaves), so
autograd through the views of a slab gives the slab's gradient, with zeros
in the tail.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import pytree
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class LayoutTable:
    """Per-leaf slab layout of a params tree (see module docstring)."""

    keys: tuple  # leaf paths joined by "/", in leaf order
    shapes: tuple  # trailing (per-client) shape of each leaf
    dtypes: tuple
    sizes: tuple  # flat column count of each leaf
    offsets: tuple  # column offset of each leaf in the slab
    dim: int  # true concatenated width
    dim_aligned: int  # slab width: dim rounded up to the 128 multiple
    structure: Any = dataclasses.field(default=None, compare=False, hash=False)  # the template

    @classmethod
    def build(cls, template: dict) -> "LayoutTable":
        if not template:
            raise ValueError("LayoutTable.build: empty params tree")
        leaves = pytree.leaves(template)
        keys = tuple("/".join(p) for p in pytree.paths(template))
        shapes = tuple(tuple(x.shape) for x in leaves)
        dtypes = tuple(x.dtype for x in leaves)
        sizes = tuple(int(math.prod(s)) for s in shapes)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        return cls(keys=keys, shapes=shapes, dtypes=dtypes, sizes=sizes,
                   offsets=tuple(offsets), dim=off,
                   dim_aligned=ops.aligned_dim(off),
                   structure=pytree.tree_map(lambda _: 0, template))

    def ravel(self, tree: dict) -> torch.Tensor:
        """Tree with any leading shape -> ``(*lead, dim_aligned)`` f32
        matrix, tail columns zero."""
        leaves = pytree.leaves(tree)
        first = leaves[0]
        head = tuple(first.shape[: first.dim() - len(self.shapes[0])])
        parts = [x.to(torch.float32).reshape(head + (s,)) for x, s in zip(leaves, self.sizes)]
        pad = self.dim_aligned - self.dim
        if pad:
            parts.append(first.new_zeros(head + (pad,), dtype=torch.float32))
        return torch.cat(parts, dim=-1)

    def unravel(self, mat: torch.Tensor) -> dict:
        """``(*lead, >= dim)`` matrix -> tree with that leading shape."""
        if mat.shape[-1] < self.dim:
            msg = (f"LayoutTable.unravel: matrix width {mat.shape[-1]} < "
                   f"layout dim {self.dim}")
            raise ValueError(msg + " — slab built from a different template")
        head = tuple(mat.shape[:-1])
        return pytree.unflatten(self.structure, [
            mat[..., off: off + size].reshape(head + shape).to(dt)
            for off, size, shape, dt in zip(self.offsets, self.sizes, self.shapes, self.dtypes)])

    def slab(self, template: dict, m: int) -> torch.Tensor:
        """Broadcast a params tree to the (m, dim_aligned) initial slab."""
        vec = self.ravel(template)
        return vec.expand((m,) + tuple(vec.shape)).clone()
