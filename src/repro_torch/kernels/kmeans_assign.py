"""Wrapper of the Hopper k-means assignment kernel (``csrc/kmeans_assign.cu``).

Replaces ``repro.kernels.kmeans_assign.kmeans_assign_pallas``: nearest
centroid label (int32) and clamped squared distance (f32) per point.

:func:`kmeans_plan` is the launch plan, a function of host ints: the
shared-memory row stride, the lane groups, the centroids staged a round
trip, the points a block, the grid and the dynamic shared memory. The
kernel refuses a plan it does not take.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

ASSIGN = _build.Kernel("kmeans_assign.cu", "kmeans_assign_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * 8)

WARPS = 8                     # points a block, one warp each
SMEM_BYTES = 96 * 1024        # shared memory a block takes when its rows fit
MAX_SMEM_BYTES = 232_448      # a block's most on an H100 (227 KB)


class KmeansPlan(NamedTuple):
    vec: bool        # 16-byte copies
    stride: int      # floats between shared rows
    groups: int      # lane groups a warp: centroids in flight per point
    chunk: int       # centroids staged a round trip (k when they fit)
    per_lane: int    # centroids a lane group takes in one pass over a point (1 or 4)
    warps: int       # points a block
    blocks: int
    smem_bytes: int


def row_stride(f: int) -> int:
    """f rounded up to 4 floats, plus 4 when that is a multiple of 8, so
    that stride / 4 is odd: 8 lanes reading a float4 from each of 8 rows
    touch all 32 banks once."""
    s = -(-f // 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def kmeans_plan(m: int, k: int, f: int, points_ptr: int, centroids_ptr: int) -> KmeansPlan:
    """The launch for m points and k centroids (both > 0) of width f:
    WARPS points a block, and as many centroids as fit SMEM_BYTES beside
    them (all k when they do, so the block makes one round trip to memory);
    fewer points a block, then up to MAX_SMEM_BYTES, when a wide f leaves
    no room for a centroid. Lane groups: the power of two at or above
    min(k, 32); a group takes one centroid a pass while a chunk has at most
    one a group, else 4. The 16-byte copies when f % 4 == 0 and both inputs
    start on 16-byte boundaries. Raises when one point and one centroid do
    not fit a block's shared memory (f above about 29,000)."""
    if min(m, k) <= 0 or f < 0:
        raise ValueError(f"kmeans_plan: m, k must be positive and f not negative, got "
                         f"{(m, k, f)}")
    s = row_stride(f)
    warps, floats = WARPS, SMEM_BYTES // 4
    while warps > 1 and (warps + 1) * s + 1 > floats:
        warps //= 2
    if (warps + 1) * s + 1 > floats:
        floats = MAX_SMEM_BYTES // 4
    if (warps + 1) * s + 1 > floats:
        raise ValueError(f"kmeans_plan: width {f} does not fit a block's shared memory")
    chunk = min(k, (floats - warps * s) // (s + 1))
    groups = 1 << (min(k, 32) - 1).bit_length()
    vec = f % 4 == 0 and (points_ptr | centroids_ptr) % 16 == 0
    per_lane = 1 if chunk <= groups else 4
    return KmeansPlan(vec, s, groups, chunk, per_lane, warps, -(-m // warps),
                      4 * ((warps + chunk) * s + chunk))


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
    plan = kmeans_plan(m, k, f, p.data_ptr(), c.data_ptr())
    ASSIGN(dev, _build.ptr(p), _build.ptr(c), _build.ptr(labels), _build.ptr(dist), m, k, f,
           int(plan.vec), plan.stride, plan.groups, plan.chunk, plan.per_lane, plan.warps,
           plan.blocks, plan.smem_bytes)
    return labels, dist
