"""Wrapper of the Hopper cohort gather kernel (``csrc/cohort_gather.cu``).

Replaces ``repro.kernels.masked_gather_mix_scatter.cohort_gather_pallas``:
``out[i] = full[min(idx[i], m - 1)]``, (m, d) -> (c, d) f32, O(c·d) bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

GATHER = _build.Kernel("cohort_gather.cu", "cohort_gather_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int])


def cohort_gather_cuda(full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """full (m, d) contiguous f32, idx (c,) int on the same CUDA device ->
    (c, d) f32. An int64 ``idx`` is cast to int32 once."""
    if not (full.is_cuda and idx.is_cuda) or full.device != idx.device:
        raise ValueError("cohort_gather_cuda: expects full and idx on one CUDA device")
    if full.dtype != torch.float32:
        raise TypeError(f"cohort_gather_cuda: full must be float32, got {full.dtype}")
    if not full.is_contiguous() or not idx.is_contiguous():
        raise ValueError("cohort_gather_cuda: full and idx must be contiguous")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cohort_gather_cuda: idx must be int32 or int64, got {idx.dtype}")
    m, d = full.shape
    c = idx.shape[0]
    out = torch.empty((c, d), dtype=torch.float32, device=full.device)
    if c == 0 or d == 0:
        return out
    if m == 0:
        raise ValueError("cohort_gather_cuda: cannot gather rows from an empty state")
    idx = idx.to(torch.int32)
    vec4 = d % 4 == 0 and full.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    GATHER(full.device, _build.ptr(full), _build.ptr(idx), _build.ptr(out), c, m, d,
           int(vec4))
    return out
