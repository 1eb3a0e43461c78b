"""K-means + silhouette scoring over collaboration vectors (Alg. 2).

K-means++ seeding from a ``torch.Generator``, Lloyd iterations in a Python
loop with the assignment in the ``kmeans_assign`` kernel (51 launches per
``kmeans`` at the default 50 iterations), and the exact O(m²) silhouette
score of §IV-C. ``choose_num_streams`` is Algorithm 2: sweep k, score each
clustering with a communication/personalization trade-off c(k, s_k), and
return the argmax.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, f)
    labels: torch.Tensor  # (m,) int32
    inertia: torch.Tensor  # scalar — Eq. 11 objective


def _plusplus_init(gen, points, k):
    """K-means++ seeding (greedy D² sampling) from ``gen``."""
    m = points.shape[0]
    centroids = points.new_zeros((k, points.shape[1]))
    first = torch.randint(0, m, (1,), generator=gen, device=points.device)
    centroids[0] = points[first[0]]
    for i in range(1, k):
        d = torch.sum((points[:, None, :] - centroids[None, :i, :]) ** 2, dim=-1)
        dmin = torch.amin(d, dim=1)
        # all points on the chosen centroids: draw uniformly, as a zero
        # total would leave nothing to sample
        weights = torch.where(torch.sum(dmin) > 1e-12, dmin, torch.ones_like(dmin))
        idx = torch.multinomial(weights, 1, generator=gen)
        centroids[i] = points[idx[0]]
    return centroids


def kmeans(gen, points, k: int, *, iters: int = 50,
           init_centroids=None) -> KMeansResult:
    """Lloyd's algorithm on (m, f) points with K-means++ init.

    ``init_centroids`` (k, f) replaces the seeding (the parity tests pass
    the reference's seeds); ``gen`` is then unused and may be None.
    """
    points = points.float()
    if init_centroids is None:
        centroids = _plusplus_init(gen, points, k)
    else:
        centroids = init_centroids.to(points).clone()
    for _ in range(iters):
        labels, _ = ops.kmeans_assign(points, centroids)
        onehot = F.one_hot(labels.long(), k).float()  # (m, k)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ points
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # empty clusters keep their centroid
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    labels, sqd = ops.kmeans_assign(points, centroids)
    # the paper's Eq. 11 sums (non-squared) distances
    inertia = torch.sum(torch.sqrt(torch.clamp_min(sqd, 0.0)))
    return KMeansResult(centroids, labels, inertia)


def silhouette_score(points, labels):
    """Exact mean silhouette over (m, f) points with int labels.

    s(i) = (b_i − a_i) / max(a_i, b_i); a = mean intra-cluster distance
    (excluding self), b = smallest mean distance to another cluster.
    Singleton clusters get s(i) = 0 (sklearn convention).
    """
    points = points.float()
    m = points.shape[0]
    sq = torch.sum(points ** 2, dim=1)
    d = torch.sqrt(torch.clamp_min(sq[:, None] + sq[None, :] - 2 * points @ points.T, 0.0))
    labels = labels.long()
    same = labels[:, None] == labels[None, :]
    not_self = ~torch.eye(m, dtype=torch.bool, device=points.device)
    intra = same & not_self
    intra_cnt = torch.sum(intra, dim=1)
    a = torch.where(
        intra_cnt > 0,
        torch.sum(torch.where(intra, d, torch.zeros_like(d)), dim=1)
        / torch.clamp_min(intra_cnt, 1),
        torch.zeros_like(sq))
    onehot = F.one_hot(labels, m).float()  # labels < m always
    cnt = onehot.sum(dim=0)
    mean_to = (d @ onehot) / torch.clamp_min(cnt[None, :], 1.0)
    own = onehot.bool()
    mean_to = torch.where(own | (cnt[None, :] == 0),
                          torch.full_like(mean_to, float("inf")), mean_to)
    b = torch.amin(mean_to, dim=1)
    s = torch.where(
        (intra_cnt > 0) & torch.isfinite(b),
        (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-12),
        torch.zeros_like(a))
    return torch.mean(s)


def default_tradeoff(k: int, s: float, *, comm_penalty: float = 0.02) -> float:
    """A typical c(k, s): increasing in silhouette, decreasing in #streams."""
    return float(s) - comm_penalty * k


def choose_num_streams(gen, w_vectors, *, k_max: int | None = None,
                       tradeoff: Callable[[int, float], float] = default_tradeoff,
                       iters: int = 50):
    """Algorithm 2 — silhouette-based selection of m_t.

    Sweeps k = 2..k_max, scores the silhouette of each K-means clustering
    of the collaboration vectors with ``tradeoff`` and returns
    (best_k, {k: (silhouette, score, KMeansResult)}).
    """
    m = w_vectors.shape[0]
    k_max = k_max or m - 1
    results = {}
    best_k, best_score = 1, float("-inf")
    for k in range(2, k_max + 1):
        res = kmeans(gen, w_vectors, k, iters=iters)
        s = float(silhouette_score(w_vectors, res.labels))
        score = tradeoff(k, s)
        results[k] = (s, score, res)
        if score > best_score:
            best_k, best_score = k, score
    return best_k, results
