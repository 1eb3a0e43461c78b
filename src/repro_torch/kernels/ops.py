"""Dispatch layer over the hand-written Hopper kernels.

Every op picks an implementation:
  * ``impl="cuda"`` — the hand-written kernel; the tensors must be on a
    CUDA device, and a CPU tensor raises;
  * ``impl="ref"``  — the plain torch version from
    :mod:`repro_torch.kernels.ref`, on any device (for comparisons);
  * ``impl=None``   — the kernel for CUDA tensors, ``ref`` for CPU tensors.

There is no environment override and no fallback: a CUDA tensor under
``impl=None`` runs the kernel or raises. The cohort ops have no ``_slab``
/ ``_hbm`` variants either: on Hopper one kernel touches only the cohort
rows, which covers both TPU variants.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cohort_gather import cohort_gather_cuda
from repro_torch.kernels.flash_attention import check_args as check_flash_args
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_cuda, needs_grad
from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda
from repro_torch.kernels.masked_mix_scatter import masked_mix_scatter_cuda
from repro_torch.kernels.mix_aggregate import ELEM_BYTES, mix_aggregate_cuda
from repro_torch.kernels.pairwise_delta import gram_cuda

ALIGN = 128  # slab width multiple, kept from the reference's TPU lane width
MIX_DTYPES = tuple(ELEM_BYTES)  # θ's dtypes the mix kernel takes: float32, bfloat16


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
    """out[i] = sum_j w[i,j] theta[j];  w (k, m), theta (m, d) -> (k, d) in
    θ's dtype, W cast to f32 and every sum in f32.

    The kernel takes θ in float32 or bfloat16 (``MIX_DTYPES``) where it
    lies, and reads a bf16 θ in its storage dtype. Two routes, picked from
    k and m (``mix_aggregate.mix_plan``): at k, m <= 16 the few-row route,
    a stream of θ at the HBM rate; else the register-tiled route, f32 θ
    (a bf16 θ through an f32 copy). Each output is one FMA chain from +0
    over j in order on either route, so an f32 output has the same bits on
    both and a bf16 output is that f32 sum rounded once to nearest-even.
    The plain version sums in cuBLAS's or the CPU's order instead.
    """
    if _impl(impl, theta) == "ref":
        return ref.mix_aggregate(w, theta)
    return mix_aggregate_cuda(w, theta)


def masked_mix_scatter(w, theta, idx, mask, full, *, impl=None):
    """Fused cohort mix + scatter: ``full[idx[i]] = (w @ theta)[i]`` where
    ``mask[i]``; pad slots (sentinel index, mask 0) are dropped.

    w (c, c); theta (c, d); idx/mask (c,); full (m, d) -> (m, d). The CUDA
    kernel writes ``full`` in place and returns it; the plain version
    returns a new tensor. Either way callers use the return value and do
    not reuse ``full`` afterwards.
    """
    if full.dim() != 2 or theta.dim() != 2:
        raise ValueError(f"full and theta must be 2-D, got {tuple(full.shape)} and "
                         f"{tuple(theta.shape)}")
    d = full.shape[1]
    if theta.shape[1] != d:
        raise ValueError(
            f"masked_mix_scatter: upload width {theta.shape[1]} != state "
            f"width {d} — the layout table and the slab "
            "disagree (state rebuilt from a different params template?)")
    c = w.shape[0]
    if w.dim() != 2 or tuple(w.shape) != (c, c):
        raise ValueError(f"w must be square (c, c), got {tuple(w.shape)}")
    if tuple(theta.shape) != (c, d):
        raise ValueError(f"theta must be {(c, d)} to match w {tuple(w.shape)} and full "
                         f"{tuple(full.shape)}, got {tuple(theta.shape)}")
    if tuple(idx.shape) != (c,) or tuple(mask.shape) != (c,):
        raise ValueError(f"idx/mask must be ({c},), got {tuple(idx.shape)}/{tuple(mask.shape)}")
    if _impl(impl, full) == "ref":
        return ref.masked_mix_scatter(w, theta, idx, mask, full)
    return masked_mix_scatter_cuda(w, theta, idx, mask, full)


def cohort_gather(full, idx, *, impl=None):
    """Round-start cohort gather ``out[i] = full[min(idx[i], m-1)]``;
    full (m, d), idx (c,) -> (c, d)."""
    if full.dim() != 2:
        raise ValueError(f"full must be (m, d), got {tuple(full.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be (c,), got {tuple(idx.shape)}")
    if _impl(impl, full) == "ref":
        return ref.cohort_gather(full, idx)
    return cohort_gather_cuda(full, idx)


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


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, impl=None):
    """Block-wise fused attention over (B, H, S, Dh), see
    :func:`repro_torch.kernels.ref.flash_attention` for the function.

    q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh) with Hq % Hkv == 0 and
    Sk >= 1; the result is (B, Hq, Sq, Dh) in q's dtype, accumulated in
    f32. ``window`` and ``softcap`` apply when they are not None (the
    reference's kernel's test, not its ops path's truthiness). The CUDA
    kernel takes any batch, head and sequence strides (the last dim
    contiguous), so (B, S, H, Dh) projections pass as ``.transpose(1, 2)``
    views, and returns a view over (B, Sq, Hq, Dh) memory. Where autograd
    records the call, the kernel runs inside :class:`FlashAttentionFn`,
    whose backward is the plain version's; the plain path is ordinary
    autograd.
    """
    check_flash_args(q, k, v, window, softcap)
    if _impl(impl, q) == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap, flash_attention_cuda)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
