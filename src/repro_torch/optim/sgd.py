"""SGD with heavy-ball momentum, the paper's optimizer (η=0.1, β=0.9).

Two forms:

* the tree form of the reference, :func:`sgd_init` and :func:`sgd_update`,
  pure functions over nested dicts of tensors (a bare tensor is a tree of
  one leaf), every operation in the leaves' dtype as the reference's;
  ``momentum_dtype`` lets large models keep the buffer in bf16. The
  transformer train step (:mod:`repro_torch.launch.steps`) uses it;
* :func:`sgd_update_`, one tensor updated IN PLACE, usually the
  (U, dim_aligned) slab of the clients being trained: ``v ← βv + g`` and
  ``p ← p − ηv``. In-place is safe because every caller owns a fresh copy
  of the rows it trains (:func:`repro_torch.federated.client.make_local_sgd`
  clones the slab first), and it saves one slab-sized buffer per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.pytree import tree_map


def sgd_init(params, *, momentum: float = 0.9, momentum_dtype=None):
    """Zero momentum buffers shaped like ``params``, in ``momentum_dtype``
    or each leaf's dtype; ``()`` when momentum is 0."""
    if momentum == 0.0:
        return ()
    return tree_map(lambda p: torch.zeros_like(p, dtype=momentum_dtype or p.dtype), params)


def sgd_update(grads, state, params, *, lr, momentum: float = 0.9, weight_decay: float = 0.0):
    """Returns (new_params, new_state); the inputs are not written."""
    if weight_decay:
        grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
    if momentum == 0.0:
        return tree_map(lambda p, g: p - lr * g, params, grads), ()
    new_state = tree_map(lambda v, g: (momentum * v.to(g.dtype) + g).to(v.dtype), state, grads)
    new_params = tree_map(lambda p, v: p - lr * v.to(p.dtype), params, new_state)
    return new_params, new_state


@torch.no_grad()
def sgd_update_(param, grad, buf, *, lr, momentum: float = 0.9):
    """One step, in place on ``param`` and ``buf``; returns ``param``."""
    if momentum == 0.0:
        param.sub_(lr * grad)
        return param
    buf.mul_(momentum).add_(grad)
    param.sub_(lr * buf)
    return param
