"""Wrapper of the Hopper Gram kernel (``csrc/gram.cu``).

Replaces ``repro.kernels.pairwise_delta.gram_pallas``. The kernel computes
``G Gᵀ`` of the (m, d) stacked gradients with split-K over d and a
deterministic second pass; Δ is formed from it in plain torch by
:func:`repro_torch.kernels.ops.pairwise_delta`, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

GRAM = _build.Kernel("gram.cu", "gram_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong])

TILE = 128  # output tile edge in csrc/gram.cu
DEPTH = 32  # d-columns staged per step in csrc/gram.cu


def split_plan(m: int, d: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunk): cut d into ``splits`` ranges of ``chunk`` columns,
    a multiple of the staging depth, so that the grid holds about two
    blocks per SM."""
    tiles = -(-m // TILE)
    want = max(1, 2 * sm_count // (tiles * tiles))
    chunk = -(-d // want)
    chunk = -(-chunk // DEPTH) * DEPTH
    return -(-d // chunk), chunk


def gram_cuda(g: torch.Tensor) -> torch.Tensor:
    """(m, d) f32 CUDA tensor -> (m, m) f32 Gram matrix."""
    if not g.is_cuda:
        raise ValueError("gram_cuda: expects a CUDA tensor")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"gram_cuda: expects a 2-D float32 tensor, got "
                        f"{g.dim()}-D {g.dtype}")
    g = g.contiguous()
    m, d = g.shape
    out = torch.empty((m, m), dtype=torch.float32, device=g.device)
    if m == 0:
        return out
    if d == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    splits, chunk = split_plan(m, d, sms)
    partial = torch.empty((splits, m, m), dtype=torch.float32, device=g.device)
    GRAM(g.device, _build.ptr(g), _build.ptr(partial), _build.ptr(out), m, d,
         splits, chunk)
    return out
