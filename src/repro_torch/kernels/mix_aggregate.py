"""Wrapper of the Hopper mix kernel (``csrc/mix_aggregate.cu``).

Replaces ``repro.kernels.mix_aggregate.mix_aggregate_pallas``:
``out(k, d) = W(k, m) · θ(m, d)``, f32 accumulate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MIX = _build.Kernel("mix_aggregate.cu", "mix_aggregate_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong])


def mix_aggregate_cuda(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """w (k, m), theta (m, d) float32 CUDA tensors -> (k, d) float32.

    W is cast to float32 like the reference does; θ must already be
    float32 (the slab always is). d == 0 returns early without a launch.
    """
    if not (w.is_cuda and theta.is_cuda) or w.device != theta.device:
        raise ValueError("mix_aggregate_cuda: expects both tensors on one CUDA device")
    if w.dim() != 2 or theta.dim() != 2 or w.shape[1] != theta.shape[0]:
        raise ValueError(f"mix_aggregate_cuda: shapes {tuple(w.shape)} x "
                         f"{tuple(theta.shape)} do not chain")
    if theta.dtype != torch.float32:
        raise TypeError(f"mix_aggregate_cuda: theta must be float32, got {theta.dtype}")
    k, m = w.shape
    d = theta.shape[1]
    out = torch.empty((k, d), dtype=torch.float32, device=theta.device)
    if d == 0 or k == 0:
        return out
    if m == 0:
        return out.zero_()
    w = w.to(torch.float32).contiguous()
    theta = theta.contiguous()
    MIX(theta.device, _build.ptr(w), _build.ptr(theta), _build.ptr(out), k, m, d)
    return out
