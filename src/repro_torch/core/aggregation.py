"""PS-side dense aggregation rules (paper Eq. 1/8 and the §IV-B variant).

Every rule takes a client-stacked state, either a dict of (m, ...) leaves
or one (m, d) slab, and returns the same kind:

  * ``fedavg``        — Eq. 1: one convex combination, broadcast to all m;
  * ``user_centric``  — Eq. 8: θ_i ← Σ_j W[i,j] θ_j (m downlink streams);
  * ``clustered``     — §IV-B: m_t centroid rules, group-cast to members.

The mix is a (rules, m) × (m, d) product in the ``mix_aggregate`` kernel.
The rules are column-independent, so a slab is mixed in ONE launch over all
its columns, where the reference launches once per leaf. The masked cohort
rules come with a later slice (ROADMAP A10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _mix_tree(w, stacked):
    """Apply mixing matrix w (k, m) to a slab or to each leaf of a dict."""

    def leaf(x):
        out = ops.mix_aggregate(w, x.reshape(x.shape[0], -1))
        return out.reshape((w.shape[0],) + tuple(x.shape[1:]))

    if isinstance(stacked, torch.Tensor):
        return leaf(stacked)
    return {k: leaf(v) for k, v in stacked.items()}


def _map(fn, stacked):
    if isinstance(stacked, torch.Tensor):
        return fn(stacked)
    return {k: fn(v) for k, v in stacked.items()}


def fedavg(stacked, n):
    """Eq. 1 with w_i = n_i / Σ n_j, result broadcast back to all clients."""
    m = n.shape[0]
    w = (n / torch.sum(n)).float()[None, :]  # (1, m)
    mixed = _mix_tree(w, stacked)
    return _map(lambda x: x.expand((m,) + tuple(x.shape[1:])).clone(), mixed)


def user_centric(stacked, w):
    """Eq. 8 — full per-client personalization; w is the (m, m) matrix."""
    return _mix_tree(w, stacked)


def centroid_rules(w, labels, num_clusters):
    """(m_t, m) centroid rules: the mean of the W rows of each cluster."""
    onehot = F.one_hot(labels.long(), num_clusters).float()  # (m, m_t)
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)
    return (onehot.T @ w) / counts[:, None]


def clustered(stacked, w, labels, num_clusters):
    """§IV-B — m_t centroid aggregation rules, group-cast to members.

    stacked: slab or dict of locally optimized models; w (m, m); labels
    (m,) cluster assignment from K-means over rows of w; num_clusters m_t.
    Client i receives the mix of its cluster's centroid rule.
    """
    mixed = _mix_tree(centroid_rules(w, labels, num_clusters), stacked)
    idx = labels.long()
    return _map(lambda x: x[idx], mixed)


def renormalize_rows(w, eps: float = 1e-12):
    """Rescale rows to sum to 1; all-zero rows stay zero (0/eps)."""
    return w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), eps)
