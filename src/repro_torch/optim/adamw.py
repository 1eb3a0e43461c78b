"""AdamW (``repro.optim.adamw``), provided for the transformer configs; the
paper does not use it. Moments in f32, pure functions over nested dicts."""
from __future__ import annotations

import torch

from repro_torch.core.pytree import leaves, tree_map


def adamw_init(params):
    """f32 first and second moments shaped like ``params`` and a step
    count, a 0-d int32 tensor on the params' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """Returns (new_params, new_state); the inputs are not written."""
    count = state["count"] + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state["mu"], grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
                  state["nu"], grads)
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)

    def upd(p, m, v):
        step = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype)

    return tree_map(upd, params, mu, nu), {"mu": mu, "nu": nu, "count": count}
