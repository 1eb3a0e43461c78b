"""Dispatch layer over the hand-written Hopper kernels.

Every op picks an implementation:
  * ``impl="cuda"`` — the hand-written kernel; the tensors must be on a
    CUDA device, and a CPU tensor raises;
  * ``impl="ref"``  — the plain torch version from
    :mod:`repro_torch.kernels.ref`, on any device (for comparisons);
  * ``impl=None``   — the kernel for CUDA tensors, ``ref`` for CPU tensors.

There is no environment override and no fallback: a CUDA tensor under
``impl=None`` runs the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda
from repro_torch.kernels.mix_aggregate import mix_aggregate_cuda
from repro_torch.kernels.pairwise_delta import gram_cuda

ALIGN = 128  # slab width multiple, kept from the reference's TPU lane width


def aligned_dim(d: int) -> int:
    """Round a flat feature dim up to the 128 multiple (the slab width)."""
    return -(-int(d) // ALIGN) * ALIGN


def _impl(impl, tensor):
    if impl is None:
        return "cuda" if tensor.is_cuda else "ref"
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown kernel impl {impl!r} (expected 'cuda', 'ref' or None)")
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{tensor.device}")
    return impl


def mix_aggregate(w, theta, *, impl=None):
    """out[i] = sum_j w[i,j] theta[j];  w (k, m), theta (m, d) -> (k, d)."""
    if _impl(impl, theta) == "ref":
        return ref.mix_aggregate(w, theta)
    return mix_aggregate_cuda(w, theta)


def gram(g, *, impl=None):
    """G Gᵀ of (m, d) -> (m, m) f32."""
    if _impl(impl, g) == "ref":
        return ref.gram(g)
    return gram_cuda(g.to(torch.float32))


def pairwise_delta(g, *, impl=None):
    """Pairwise squared distances between rows of g (m, d) -> (m, m).

    Only the Gram matrix runs in the kernel; Δ = max(G_ii + G_jj − 2G_ij, 0)
    is formed here in plain torch, as the reference's ops layer does.
    """
    return ref.delta_from_gram(gram(g, impl=impl))


def kmeans_assign(points, centroids, *, impl=None):
    """Nearest-centroid assignment -> (labels (m,) int32, sqdist (m,) f32)."""
    if _impl(impl, points) == "ref":
        return ref.kmeans_assign(points, centroids)
    return kmeans_assign_cuda(points, centroids)
