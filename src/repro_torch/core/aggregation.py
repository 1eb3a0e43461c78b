"""PS-side dense aggregation rules (paper Eq. 1/8 and the §IV-B variant).

Every rule takes a client-stacked state, either a dict of (m, ...) leaves
or one (m, d) slab, and returns the same kind:

  * ``fedavg``        — Eq. 1: one convex combination, broadcast to all m;
  * ``user_centric``  — Eq. 8: θ_i ← Σ_j W[i,j] θ_j (m downlink streams);
  * ``clustered``     — §IV-B: m_t centroid rules, group-cast to members.

The mix is a (rules, m) × (m, d) product in the ``mix_aggregate`` kernel.
The rules are column-independent, so a slab is mixed in ONE launch over all
its columns, where the reference launches once per leaf.

Partial participation: the fixed-shape ``masked_*`` rules below express
every cohort rule as per-slot (c, c) rows over a padded cohort (pad slots
carry the sentinel index m and mask False, and get zero column weight
before the row renormalization), and the round-end PS step is ONE
``masked_mix_scatter`` kernel pass over the (c, d) upload slab
(:func:`mix_scatter_flat`); the round starts with ONE ``cohort_gather``
(:func:`cohort_gather`) of each slab it reads. A strategy without a PS
mix writes its real slots back with :func:`scatter_rows`.
``cohort_mixing_matrix``, ``cohort_column_mixing``, ``fedavg_cohort``,
``user_centric_cohort`` and ``clustered_cohort`` are the unpadded rules
that the padded ones must reproduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pytree
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


def cohort_mixing_matrix(w, cohort):
    """W sliced to the cohort's rows and columns, rows renormalized.

    (c, c), row-stochastic up to float error; a row with no mass on the
    cohort falls back to the identity row (that client keeps its own
    locally updated model).
    """
    cohort = cohort.long()
    wc = w[cohort][:, cohort]
    s = torch.sum(wc, dim=1, keepdim=True)
    eye = torch.eye(wc.shape[0], dtype=wc.dtype, device=wc.device)
    return torch.where(s > 1e-12, wc / torch.clamp_min(s, 1e-12), eye)


def cohort_column_mixing(w, cohort):
    """W's columns sliced to the cohort, every row renormalized: (m, c),
    plus the (m,) bool marking rows with any mass on the cohort (a row
    without it is the caller's cue to keep the previous model)."""
    cols = w[:, cohort.long()]
    s = torch.sum(cols, dim=1, keepdim=True)
    return cols / torch.clamp_min(s, 1e-12), s[:, 0] > 1e-12


def fedavg_cohort(stacked_cohort, n_cohort, m):
    """Eq. 1 over the cohort's uploads (unpadded); the new global is
    broadcast to all m clients."""
    w = (n_cohort / torch.sum(n_cohort)).float()[None, :]  # (1, c)
    mixed = _mix_tree(w, stacked_cohort)
    return _map(lambda x: x.expand((m,) + tuple(x.shape[1:])).clone(), mixed)


def user_centric_cohort(stacked_cohort, w, cohort):
    """Eq. 8 restricted to the cohort (unpadded): the (c, ...) mix."""
    return _mix_tree(cohort_mixing_matrix(w, cohort), stacked_cohort)


def clustered_cohort(theta_c, w, labels, num_clusters, cohort):
    """§IV-B with centroid rules rebuilt from the cohort (unpadded), on
    the (c, d) cohort slab.

    Each centroid rule sums the W rows of its participating members over
    the cohort columns and is renormalized; a participant whose rule has
    no mass on the cohort keeps its own locally updated model.
    """
    cohort = cohort.long()
    lc = labels.long()[cohort]
    onehot = F.one_hot(lc, num_clusters).to(w.dtype)  # (c, mt)
    raw = onehot.T @ w[cohort][:, cohort]  # (mt, c)
    mixed = ops.mix_aggregate(renormalize_rows(raw), theta_c)
    alive = (torch.sum(raw, dim=1) > 1e-12)[lc]  # (c,)
    return torch.where(alive[:, None], mixed[lc], theta_c)


def safe_gather_index(idx, m):
    """Clamp the pad sentinel for gathers (pad slots read row m-1)."""
    return torch.clamp_max(idx, m - 1)


def masked_cohort_matrix(w, idx, mask):
    """Fixed-shape :func:`cohort_mixing_matrix`: (c, c) with zeroed pad
    columns, rows renormalized; degenerate rows fall back to identity."""
    safe = safe_gather_index(idx, w.shape[0]).long()
    wc = w[safe][:, safe] * mask.to(w.dtype)[None, :]
    s = torch.sum(wc, dim=1, keepdim=True)
    eye = torch.eye(wc.shape[0], dtype=wc.dtype, device=wc.device)
    return torch.where(s > 1e-12, wc / torch.clamp_min(s, 1e-12), eye)


def masked_clustered_rows(w, labels, num_clusters, idx, mask):
    """Fixed-shape :func:`clustered_cohort` as per-slot (c, c) rows.

    Slot i's row is its cluster's centroid rule rebuilt from the real
    members (renormalized over real columns); a slot whose rule has no
    mass on the cohort gets the identity row; pad rows are don't-care.
    """
    fmask = mask.to(w.dtype)
    safe = safe_gather_index(idx, w.shape[0]).long()
    lc = labels.long()[safe]
    onehot = F.one_hot(lc, num_clusters).to(w.dtype) * fmask[:, None]
    raw = onehot.T @ (w[safe][:, safe] * fmask[None, :])  # (mt, c)
    rules = renormalize_rows(raw)
    alive = (torch.sum(raw, dim=1) > 1e-12)[lc]  # (c,)
    eye = torch.eye(safe.shape[0], dtype=w.dtype, device=w.device)
    return torch.where(alive[:, None], rules[lc], eye)


def masked_group_rows(assignment_c, n_c, mask):
    """Fixed-shape per-group FedAvg rows (the CFL/Oracle cohort rule):
    slot i averages the real slots of its group, weighted by n."""
    fmask = mask.to(torch.float32)
    same = (assignment_c[:, None] == assignment_c[None, :]).to(torch.float32)
    w = same * n_c.to(torch.float32)[None, :] * fmask[None, :]
    s = torch.sum(w, dim=1, keepdim=True)
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return torch.where(s > 1e-12, w / torch.clamp_min(s, 1e-12), eye)


def masked_fedavg_weights(n_c, mask):
    """Fixed-shape Eq. 1 weights over the cohort: (1, c), pad slots 0; an
    all-masked cohort gives all-zero weights (0/eps), not NaN."""
    wn = n_c.to(torch.float32) * mask.to(torch.float32)
    return (wn / torch.clamp_min(torch.sum(wn), 1e-12))[None, :]


def masked_column_mixing(w, idx, mask):
    """W's columns sliced to the real cohort slots, rows renormalized:
    (m, c), plus the (m,) bool marking rows with any mass on the cohort."""
    safe = safe_gather_index(idx, w.shape[0]).long()
    cols = w[:, safe] * mask.to(w.dtype)[None, :]
    s = torch.sum(cols, dim=1, keepdim=True)
    return cols / torch.clamp_min(s, 1e-12), s[:, 0] > 1e-12


def _slab(full, what):
    if not isinstance(full, torch.Tensor):
        raise ValueError(
            f"{what}: the stacked state must be one (m, dim_aligned) slab "
            "(repro_torch.core.flat.LayoutTable); a dict of leaves is not "
            "supported on the cohort path")
    return full


def cohort_gather(full, safe):
    """Round-start gather ``full[safe]`` of the slab in ONE
    ``cohort_gather`` launch; ``safe`` is pre-clamped
    (:func:`safe_gather_index`)."""
    return ops.cohort_gather(_slab(full, "cohort_gather"), safe)


def scatter_rows(full, idx, rows, real):
    """``full[idx[i]] = rows[i]`` for the cohort's ``real`` members, the
    slots of its sorted prefix; the pad slots after them write nothing.
    ``real`` is a host int, so the scatter needs no sync. On the card the
    slab is written in place; on the CPU a new tensor is returned. The
    caller uses the return value either way."""
    out = _slab(full, "scatter_rows")
    if not out.is_cuda:
        out = out.clone()
    return out.index_copy_(0, idx[:real].long(), rows[:real])


def mix_scatter(full, cohort_updated, rows, idx, mask):
    """:func:`mix_scatter_flat` of a cohort-stacked update tree, raveled
    once to a (c, d) matrix in sorted-key column order."""
    return mix_scatter_flat(full, pytree.stacked_ravel(cohort_updated), rows, idx, mask)


def mix_scatter_flat(full, flat_c, rows, idx, mask):
    """Apply the per-slot (c, c) ``rows`` to the (c, d) uploads and
    scatter the real slots into the (m, d) slab, in ONE
    ``masked_mix_scatter`` launch.

    ``flat_c`` wider than the slab is sliced back (its tail columns are
    zero padding). On the card the slab is written in place: the caller
    uses the return value and does not reuse ``full``. Pad slots rely on
    the sentinel contract: ``mask`` is False wherever ``idx`` is m.
    """
    full = _slab(full, "mix_scatter")
    d = full.shape[1]
    if flat_c.shape[1] > d:
        flat_c = flat_c[:, :d].contiguous()
    return ops.masked_mix_scatter(rows, flat_c, idx, mask, full)
