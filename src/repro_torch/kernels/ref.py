"""Plain torch versions of the hand-written kernels.

These are the semantic ground truth of :mod:`repro_torch.kernels`: the CPU
path of :mod:`repro_torch.kernels.ops` dispatches here, the CPU parity
tests compare them with ``repro.kernels.ref``, and ``chip_smoke.py`` holds
every CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def mix_aggregate(w, theta):
    """User-centric mixing: ``out[i] = sum_j w[i, j] * theta[j]``.

    w (k, m), theta (m, d) -> (k, d) in ``theta.dtype``, f32 accumulate.
    """
    out = w.to(torch.float32) @ theta.to(torch.float32)
    return out.to(theta.dtype)


def cohort_gather(full, idx):
    """Cohort rows ``out[i] = full[min(idx[i], m - 1)]``.

    full (m, d), idx (c,) int -> (c, d) in ``full.dtype``. Pad slots (the
    sentinel m) read row m-1. Indices below 0, outside the slot contract,
    read row 0, as the kernel does.
    """
    safe = idx.long().clamp(0, full.shape[0] - 1)
    return full[safe]


def masked_mix_scatter(w, theta, idx, mask, full):
    """Masked cohort mix + scatter, as a new tensor (``full`` is not written).

    ``out = full`` with ``out[idx[i]] = (w @ theta)[i]`` for every slot
    with ``mask[i]`` set. Slots whose index lies outside [0, m) are
    dropped; a masked slot with an in-bounds index writes its row's
    previous value back. w (c, c) with zero pad columns, theta (c, d), idx
    and mask (c,), full (m, d) -> (m, d) in ``full.dtype``.
    """
    m = full.shape[0]
    mixed = (w.to(torch.float32) @ theta.to(torch.float32)).to(full.dtype)
    idx = idx.long()
    upd = torch.where(mask.bool()[:, None], mixed, cohort_gather(full, idx))
    keep = (idx >= 0) & (idx < m)
    out = full.clone()
    out[idx[keep]] = upd[keep]
    return out


def gram(g):
    """Gram matrix ``G G^T`` of (m, d) stacked gradients, f32 accumulate."""
    g32 = g.to(torch.float32)
    return g32 @ g32.T


def delta_from_gram(gr):
    """``max(G_ii + G_jj - 2 G_ij, 0)``: squared distances from a Gram matrix."""
    sq = torch.diagonal(gr)
    return torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gr, 0.0)


def pairwise_delta(g):
    """Pairwise squared L2 distances between rows of ``g`` (m, d) -> (m, m)."""
    return delta_from_gram(gram(g))


def kmeans_assign(points, centroids):
    """Nearest-centroid assignment.

    points (m, f), centroids (k, f) -> labels (m,) int32 and the clamped
    squared distance (m,) f32 to the chosen centroid. Ties go to the
    lowest centroid index, as ``torch.argmin`` and ``jnp.argmin`` do.
    """
    p = points.to(torch.float32)
    c = centroids.to(torch.float32)
    d = (
        torch.sum(p * p, dim=1)[:, None]
        + torch.sum(c * c, dim=1)[None, :]
        - 2.0 * (p @ c.T)
    )
    d = torch.clamp_min(d, 0.0)
    labels = torch.argmin(d, dim=1)
    return labels.to(torch.int32), d.gather(1, labels[:, None])[:, 0]


NEG_INF = -1e30  # the mask value of the reference's attention kernels


def _masked_scores(q, k, v, causal, window, softcap):
    """f32 logits (B, Hq, Sq, Sk) scaled by Dh^-0.5, softcapped and masked
    with -1e30, and v expanded to the q heads in f32."""
    g = q.shape[1] // k.shape[1]
    kx = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vx = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kx) * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), vx


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, probs_dtype=None):
    """Attention over (B, H, S, Dh), materialising the (Sq, Sk) logits.

    q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh), Hq % Hkv == 0: q head h
    reads kv head ``h // (Hq // Hkv)``. Step by step the reference's plain
    path (``repro/kernels/ops.py:150``): f32 logits scaled by Dh^-0.5, the
    tanh softcap, the mask (``col <= row`` counted from 0 for both, i.e.
    top-left causal alignment; ``col > row - window``) filled with -1e30,
    softmax, then the f32 product with v, cast to q's dtype. ``window`` and
    ``softcap`` apply when they are not None. A row whose every column is
    masked gets the uniform softmax, the mean of v.

    ``probs_dtype`` (default None: f32 throughout) rounds the normalized
    probabilities to that dtype before the product with v, as the reference
    model's ``_attend`` does; the kernel checks use it with bfloat16 as the
    control that a tile keeping P to 16 bits must beat.
    """
    s, vx = _masked_scores(q, k, v, causal, window, softcap)
    p = torch.softmax(s, dim=-1)
    if probs_dtype is not None:
        p = p.to(probs_dtype).to(torch.float32)
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)


def flash_decode_split(q, k, v, splits, *, causal=True, window=None, softcap=None):
    """:func:`flash_attention` the way the split-KV decode kernel computes
    it. The Sk keys fall into ``splits`` balanced ranges (split s holds
    keys [s·Sk // S, (s+1)·Sk // S)); each split keeps its row max m, sum
    l = Σ exp(x − m) and accumulator Σ exp(x − m)·v in f32, and the splits
    merge in order 0..S−1: M = max m_s, w_s = exp(m_s − M), out =
    Σ w_s·acc_s / max(Σ w_s·l_s, 1e-30), cast to q's dtype. A split whose
    columns are all masked has m = -1e30, so beside a split that reaches a
    key it merges with a weight of exactly 0. Scores and masks as
    :func:`flash_attention` (any Sq; the kernel takes Sq = 1). Raises
    ValueError unless 1 <= splits <= Sk (no split is empty)."""
    sk = k.shape[2]
    if not 1 <= splits <= sk:
        raise ValueError(f"flash_decode_split: splits must be in 1..Sk = {sk}, got {splits}")
    s, vx = _masked_scores(q, k, v, causal, window, softcap)
    bounds = [i * sk // splits for i in range(splits + 1)]
    parts = []
    for lo, hi in zip(bounds, bounds[1:]):
        m = s[..., lo:hi].amax(dim=-1, keepdim=True)
        p = torch.exp(s[..., lo:hi] - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhqk,bhkd->bhqd", p, vx[:, :, lo:hi])))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total, acc = 0.0, 0.0
    for m, l, a in parts:
        w = torch.exp(m - top)
        total, acc = total + w * l, acc + w * a
    return (acc / torch.clamp_min(total, 1e-30)).to(q.dtype)
