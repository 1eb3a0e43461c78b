"""SGD with heavy-ball momentum, the paper's optimizer (η=0.1, β=0.9).

The port works on one tensor, usually the (U, dim_aligned) slab of the
clients being trained, and updates it IN PLACE: ``v ← βv + g`` and
``p ← p − ηv``. In-place is safe because every caller owns a fresh copy of
the rows it trains (:func:`repro_torch.federated.client.make_local_sgd`
clones the slab first), and it saves one slab-sized buffer per step.
"""
from __future__ import annotations

import torch


def sgd_init(param: torch.Tensor, *, momentum: float = 0.9):
    """A zero momentum buffer, or None when momentum is 0."""
    if momentum == 0.0:
        return None
    return torch.zeros_like(param)


@torch.no_grad()
def sgd_update_(param, grad, buf, *, lr, momentum: float = 0.9):
    """One step, in place on ``param`` and ``buf``; returns ``param``."""
    if momentum == 0.0:
        param.sub_(lr * grad)
        return param
    buf.mul_(momentum).add_(grad)
    param.sub_(lr * buf)
    return param
