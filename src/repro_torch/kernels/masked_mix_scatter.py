"""Wrapper of the Hopper masked mix-scatter kernel (``csrc/masked_mix_scatter.cu``).

Replaces both ``repro.kernels.masked_mix_scatter.masked_mix_scatter_pallas``
and ``repro.kernels.masked_gather_mix_scatter.masked_gather_mix_scatter_pallas``:
``full[idx[i]] = (W · θ)[i]`` for the live slots (``mask[i]`` and
``0 <= idx[i] < m``), written in place, O(c·d) bytes at any m. The kernel
is mix_aggregate's register-tiled core with a scatter epilogue, launched
on ``tile_plan(c, c, d, theta, full)`` at every c (a 50-slot cohort takes the 64-row
tile: θ read once, one wave of blocks).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mix_aggregate import tile_plan

MIX_SCATTER = _build.Kernel("masked_mix_scatter.cu", "masked_mix_scatter_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int])


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a.numel() > 0 and b.numel() > 0 and a0 < b1 and b0 < a1


def masked_mix_scatter_cuda(w, theta, idx, mask, full):
    """w (c, c), theta (c, d) and full (m, d) f32, idx (c,) int, mask (c,)
    bool or int, all on one CUDA device; theta and full contiguous.

    Writes the live cohort rows of ``full`` in place and returns ``full``.
    W is cast to float32 like the reference does; an int64 ``idx`` is cast
    to int32 once. The live indices must be distinct (a ``Cohort``'s
    members strictly increase); that is not checked, as it would need a
    device sync, and nothing else is read back from the card either (the
    plan is a function of shapes and pointers). Raises when θ or W shares
    bytes with ``full``: the kernel would read rows that it is writing.
    """
    tensors = (w, theta, idx, mask, full)
    if not all(x.is_cuda for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError("masked_mix_scatter_cuda: expects all tensors on one CUDA device")
    if theta.dtype != torch.float32 or full.dtype != torch.float32:
        raise TypeError(f"masked_mix_scatter_cuda: theta and full must be float32, got "
                        f"{theta.dtype} and {full.dtype}")
    if not (theta.is_contiguous() and full.is_contiguous()):
        raise ValueError("masked_mix_scatter_cuda: theta and full must be contiguous")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"masked_mix_scatter_cuda: idx must be int32 or int64, got {idx.dtype}")
    if _overlaps(theta, full) or _overlaps(w, full):
        raise ValueError("masked_mix_scatter_cuda: theta or w overlaps full; the kernel "
                         "writes full in place, so pass a copy")
    c = w.shape[0]
    m, d = full.shape
    if c == 0 or d == 0:
        return full
    w = w.to(torch.float32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    mask = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    plan = tile_plan(c, c, d, theta.data_ptr(), full.data_ptr())
    MIX_SCATTER(full.device, _build.ptr(w), _build.ptr(theta), _build.ptr(idx),
                _build.ptr(mask), _build.ptr(full), c, m, d, plan.tile, int(plan.vec),
                plan.blocks, plan.smem_bytes)
    return full
