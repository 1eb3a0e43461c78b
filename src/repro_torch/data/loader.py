"""Federated batching.

The reference draws each epoch's shuffle with ``jax.random.permutation``
inside the jitted update (``repro/data/loader.py:18``). The port takes the
permutation as an argument instead, so the parity tests can hand it the
reference's permutations; :func:`draw_permutations` makes them from a
``torch.Generator`` for standalone runs.
"""
from __future__ import annotations

import torch


def epoch_batches(perm, x, y, batch_size):
    """Split one client's data into full batches in ``perm`` order.

    ``perm`` is a permutation of range(n) (or at least its first
    ``steps·B`` entries); the remainder is dropped, as in the reference.
    """
    n = x.shape[0]
    steps = n // batch_size
    p = perm[: steps * batch_size]
    xb = x[p].reshape((steps, batch_size) + tuple(x.shape[1:]))
    yb = y[p].reshape((steps, batch_size) + tuple(y.shape[1:]))
    return xb, yb


def draw_permutations(gen, units, epochs, n, *, device):
    """(units, epochs, n) int64: an independent permutation of range(n)
    per unit and epoch, as one argsort of uniform draws."""
    u = torch.rand((units, epochs, n), generator=gen, device=device)
    return torch.argsort(u, dim=-1)


def fixed_partition(x, y, batch_size):
    """Deterministic split into minibatches (Eq. 10 variance estimation)."""
    n = x.shape[0]
    steps = n // batch_size
    xb = x[: steps * batch_size].reshape((steps, batch_size) + tuple(x.shape[1:]))
    yb = y[: steps * batch_size].reshape((steps, batch_size) + tuple(y.shape[1:]))
    return xb, yb
