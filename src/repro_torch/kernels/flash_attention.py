"""Wrapper of the Hopper attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention``: softmax(q·kᵀ)·v
over (B, H, S, Dh) with an online softmax, GQA without an expanded copy of
K and V, top-left causal, sliding-window and softcap masks.
:func:`check_args` is the argument contract of both implementations; the
wrapper adds what the kernels themselves need.

Two hand-written kernels compute the function, and :func:`flash_route`
picks one by a stated rule: the bf16 tensor-core tile (``FLASH_TC``, route
``"tc"``) for prefill-shaped, 16-byte aligned bf16 inputs, the f32 FMA
kernel (``FLASH_FMA``, route ``"fma"``) for the rest (decode, f32,
unaligned views). Each has its own launch counter.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# q, k, v, out, strides; b, hq, hkv, sq, sk, dh, causal, window; softcap, scale
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
FLASH_TC = _build.Kernel("flash_attention.cu", "flash_attention_tc", _ARGS)
# the FMA kernel takes the dtype (0 float32, 1 bfloat16) after the strides
FLASH_FMA = _build.Kernel("flash_attention.cu", "flash_attention_fwd",
                          _ARGS[:5] + [ctypes.c_int] + _ARGS[5:])

MAX_HEAD_DIM = 256
TC_MIN_ROWS = 16  # the tile's mma rows: a shorter q would be mostly padding
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_route(q, k, v) -> str:
    """``"tc"`` (the tensor-core tile) when q, k and v are all bf16 with
    Sq >= 16 and Dh % 8 == 0, and every base pointer and every batch, head
    and sequence stride is a multiple of 16 bytes (the tile's 16-byte
    copies); ``"fma"`` (the FMA kernel) otherwise: f32, decode (Sq < 16)
    and unaligned inputs."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[2] >= TC_MIN_ROWS and q.shape[3] % 8 == 0):
        return "fma"
    aligned = all(t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                                  for s in t.stride()[:3])
                  for t in (q, k, v))
    return "tc" if aligned else "fma"


def check_args(q, k, v, window, softcap):
    """Raise ValueError unless q is (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh)
    with Hq % Hkv == 0 and Sk >= 1, window >= 1 and softcap > 0 where set."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D (B, H, S, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, Hkv, Sk, Dh) with q's B = {b} and Dh = {dh}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"flash_attention: Hq = {hq} is not a multiple of Hkv = {k.shape[1]}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: Sk must be at least 1")
    if window is not None and not window >= 1:
        raise ValueError(f"flash_attention: window must be at least 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap}")


def flash_attention_cuda(q, k, v, *, causal=True, window=None, softcap=None):
    """q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh) on one CUDA device, all
    float32 or all bfloat16, each with a contiguous last dim and any batch,
    head and sequence strides; launches the kernel :func:`flash_route`
    names. Returns (B, Hq, Sq, Dh) in q's dtype: a ``.transpose(1, 2)`` view
    over a (B, Sq, Hq, Dh) tensor, so a caller that wants (B, Sq, Hq·Dh)
    reshapes it without a copy.
    """
    check_args(q, k, v, window, softcap)
    ts = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_attention_cuda: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: q, k, v must all be float32 or all bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, dh = q.shape
    _, hkv, sk, _ = k.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention_cuda: B = {b} and Hq = {hq} must be at most 65535")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError("flash_attention_cuda: the last dim of q, k and v must be contiguous")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if b == 0 or hq == 0 or sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    ptrs = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            ctypes.cast(strides, ctypes.c_void_p))
    shape = (b, hq, hkv, sq, sk, dh, int(causal), 0 if window is None else int(window),
             0.0 if softcap is None else float(softcap), float(dh ** -0.5))
    if flash_route(q, k, v) == "tc":
        FLASH_TC(q.device, *ptrs, *shape)
    else:
        FLASH_FMA(q.device, *ptrs, _DTYPES[q.dtype], *shape)
    return out
