"""Wrapper of the Hopper k-means assignment kernel (``csrc/kmeans_assign.cu``).

Replaces ``repro.kernels.kmeans_assign.kmeans_assign_pallas``: nearest
centroid label (int32) and clamped squared distance (f32) per point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ASSIGN = _build.Kernel("kmeans_assign.cu", "kmeans_assign_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int])


def kmeans_assign_cuda(points: torch.Tensor, centroids: torch.Tensor):
    """points (m, f), centroids (k, f) CUDA tensors -> (labels, sqdist)."""
    if not (points.is_cuda and centroids.is_cuda) or points.device != centroids.device:
        raise ValueError("kmeans_assign_cuda: expects both tensors on one CUDA device")
    if points.dim() != 2 or centroids.dim() != 2 or points.shape[1] != centroids.shape[1]:
        raise ValueError(f"kmeans_assign_cuda: shapes {tuple(points.shape)} and "
                         f"{tuple(centroids.shape)} differ in width")
    m, f = points.shape
    k = centroids.shape[0]
    if k == 0:
        raise ValueError("kmeans_assign_cuda: no centroids")
    dev = points.device
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    dist = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return labels, dist
    p = points.to(torch.float32).contiguous()
    c = centroids.to(torch.float32).contiguous()
    ASSIGN(dev, _build.ptr(p), _build.ptr(c), _build.ptr(labels),
           _build.ptr(dist), m, k, f)
    return labels, dist
