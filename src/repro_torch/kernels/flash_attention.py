"""Wrapper of the Hopper attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.flash_attention``: softmax(q·kᵀ)·v
over (B, H, S, Dh) with an online softmax, GQA without an expanded copy of
K and V, top-left causal, sliding-window and softcap masks.
:func:`check_args` is the argument contract of every implementation; the
wrapper adds what the kernels themselves need.

Three hand-written kernels compute the function, and :func:`flash_route`
picks one by a stated rule, on aligned inputs (every base pointer and every
batch, head and sequence stride a multiple of 16 bytes) with Dh % 8 == 0
and Dh <= 256: decode (Sq = 1, f32 or bf16) takes the split-KV decode
kernel (``FLASH_DEC``, route ``"decode"``), bf16 with Sq >= 16 the
tensor-core tile (``FLASH_TC``, route ``"tc"``); everything else (f32
prefill, Sq 2-15, unaligned views, odd head dims) takes the f32 FMA kernel
(``FLASH_FMA``, route ``"fma"``). Each has its own launch counter.

The kernels compute the forward alone. :class:`FlashAttentionFn` makes a
call differentiable: its forward is the kernel, and its backward recomputes
the plain version (:func:`repro_torch.kernels.ref.flash_attention`, P in
f32 as the kernels keep it) on the saved q, k and v and takes its
vector-Jacobian product. The reference owes no backward kernel: its
training attention is the plain ``_attend``, which XLA differentiates. A
direct call of :func:`flash_attention_cuda` on inputs that need a gradient,
under grad mode, raises rather than return a result detached from them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, ref

# q, k, v, out, strides; b, hq, hkv, sq, sk, dh, causal, window; softcap, scale
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
FLASH_TC = _build.Kernel("flash_attention.cu", "flash_attention_tc", _ARGS)
# the FMA kernel takes the dtype (0 float32, 1 bfloat16) after the strides
_FMA_ARGS = _ARGS[:5] + [ctypes.c_int] + _ARGS[5:]
FLASH_FMA = _build.Kernel("flash_attention.cu", "flash_attention_fwd", _FMA_ARGS)
# the decode kernel takes the FMA kernel's arguments, then the split count,
# the counters (int32) and their number, the partials (f32) and theirs
FLASH_DEC = _build.Kernel("flash_attention.cu", "flash_attention_decode", _FMA_ARGS + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong])

MAX_HEAD_DIM = 256
TC_MIN_ROWS = 16  # the tile's mma rows: a shorter q would be mostly padding
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The decode kernel's constants (DEC_ROWS, DEC_REC, DEC_MAX_SPLITS in the
# source): q rows a block takes, floats of one split's partial record, and
# the most splits a launch takes.
DECODE_ROWS = 8
DECODE_RECORD_FLOATS = DECODE_ROWS * (2 + 256)
DECODE_MAX_SPLITS = 64
# blocks of the decode kernel an SM holds at once (its launch bounds)
DECODE_BLOCKS_PER_SM = 2
# the fewest keys a split gets, chosen on the card (H100): at qwen2-7b's
# decode shape over 160 keys, 32 (5 splits) ran faster than 16 (9) or 64
# (2); below it a split's fixed cost (its partial record and the merge)
# outweighs the parallelism it adds
DECODE_MIN_KEYS = 32


def flash_route(q, k, v) -> str:
    """The kernel a call takes. Inputs that are all f32 or all bf16, with
    Dh % 8 == 0, Dh <= 256 and every base pointer and every batch, head and
    sequence stride a multiple of 16 bytes (the 16-byte loads of the tile
    and the decode kernel), take ``"decode"`` (the split-KV decode kernel)
    when Sq == 1 and ``"tc"`` (the tensor-core tile) when they are bf16 with
    Sq >= 16; everything else takes ``"fma"`` (the FMA kernel): f32
    prefill, Sq 2-15, unaligned views and odd head dims."""
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        return "fma"
    return _route(q.dtype, q.shape[2], q.shape[3], (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                  q.stride()[:3] + k.stride()[:3] + v.stride()[:3])


def _route(dtype, sq, dh, ptrs, strides) -> str:
    """:func:`flash_route` of inputs of one dtype from their shape, base
    pointers and (batch, head, sequence) strides, as host ints."""
    if dh % 8 or dh > MAX_HEAD_DIM or not (
            sq == 1 or (dtype == torch.bfloat16 and sq >= TC_MIN_ROWS)):
        return "fma"
    esize = 4 if dtype == torch.float32 else 2
    # 16 divides every stride * esize exactly when it divides their gcd * esize
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16 or math.gcd(*strides) * esize % 16:
        return "fma"
    return "decode" if sq == 1 else "tc"


def decode_blocks(b: int, hq: int, hkv: int) -> int:
    """The decode kernel's blocks a split: one per batch, kv head and tile
    of up to DECODE_ROWS of the kv head's Hq / Hkv query heads."""
    return b * hkv * -(-(hq // hkv) // DECODE_ROWS)


def decode_splits(blocks: int, sk: int, sms: int) -> int:
    """How many splits of the keys the decode kernel takes: as many as fit
    ``blocks`` (:func:`decode_blocks`) times the splits into
    one wave of the ``sms`` SMs' resident block slots (DECODE_BLOCKS_PER_SM
    each; a block past them would wait for a second wave), so the grid
    reaches the SM count whenever ``blocks`` is at most it; but no split
    under DECODE_MIN_KEYS keys (the kernel's balanced splits each hold floor
    or ceil of sk / splits) and at most DECODE_MAX_SPLITS; 1 when two
    splits would fall under the minimum. A function of host ints: no
    device query."""
    return max(1, min(DECODE_BLOCKS_PER_SM * sms // blocks, sk // DECODE_MIN_KEYS,
                      DECODE_MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> the decode kernel's counters and partials,
# each as (data pointer, length, tensor). The counters are zeroed once
# (torch.zeros) and left at zero by every launch; the partials live only
# within a launch. Launches on one stream run in order, so they share the
# buffers; each grows when a launch needs more.
_DECODE_WORKSPACE: dict[tuple[int, int], tuple] = {}
# (device index, stream, B, Hq, Hkv, Sk) -> the decode launch's last five
# arguments (:func:`_decode_plan`), so that a call at a shape met before
# costs the host one lookup: the decode step is bound by the host. Holds
# the workspace's pointers, so it is emptied whenever a buffer grows, and
# when it reaches DECODE_PLANS entries (Sk rises by one a decode step).
_DECODE_PLANS: dict[tuple, tuple] = {}
DECODE_PLANS = 4096


def _decode_workspace(device, stream_handle: int, blocks: int, splits: int):
    """(counters pointer, their number, partials pointer, their number) for
    ``blocks`` counters and ``splits`` records each, growing either buffer
    that is too small."""
    key = (device.index, stream_handle)
    need = blocks * splits * DECODE_RECORD_FLOATS
    ws = _DECODE_WORKSPACE.get(key)
    if ws is None or ws[1] < blocks or ws[3] < need:
        counters = ws[4] if ws is not None and ws[1] >= blocks else torch.zeros(
            max(blocks, 1024), dtype=torch.int32, device=device)
        partials = ws[5] if ws is not None and ws[3] >= need else torch.empty(
            max(need, 2**20), dtype=torch.float32, device=device)
        ws = _DECODE_WORKSPACE[key] = (counters.data_ptr(), counters.numel(),
                                       partials.data_ptr(), partials.numel(), counters, partials)
        _DECODE_PLANS.clear()
    return ws[:4]


def _decode_plan(device, stream_handle: int, b: int, hq: int, hkv: int, sk: int):
    """The decode launch's split count (:func:`decode_splits`), counters
    pointer and number, partials pointer and number (none with one split)
    at this shape on this stream, kept in _DECODE_PLANS."""
    blocks = decode_blocks(b, hq, hkv)
    splits = decode_splits(blocks, sk, _sm_count(device.index))
    plan = (1, None, 0, None, 0) if splits == 1 else (
        splits, *_decode_workspace(device, stream_handle, blocks, splits))
    if len(_DECODE_PLANS) >= DECODE_PLANS:
        _DECODE_PLANS.clear()
    _DECODE_PLANS[device.index, stream_handle, b, hq, hkv, sk] = plan
    return plan


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
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention_cuda: q, k or v needs a gradient and grad mode is on; "
                           "the kernel's output would be detached from them (call it through "
                           "FlashAttentionFn, as ops.flash_attention does)")
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
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = q.stride()[:3] + k.stride()[:3] + v.stride()[:3] + out.stride()[:3]
    args = (*ptrs, ctypes.cast((ctypes.c_longlong * 12)(*strides), ctypes.c_void_p))
    shape = (b, hq, hkv, sq, sk, dh, int(causal), 0 if window is None else int(window),
             0.0 if softcap is None else float(softcap), float(dh ** -0.5))
    route = _route(q.dtype, sq, dh, ptrs, strides[:9])
    if route == "tc":
        FLASH_TC(q.device, *args, *shape)
    elif route == "decode":
        device = q.device
        handle = torch.cuda.current_stream(device).cuda_stream
        plan = (_DECODE_PLANS.get((device.index, handle, b, hq, hkv, sk))
                or _decode_plan(device, handle, b, hq, hkv, sk))
        FLASH_DEC.launch(device, handle, *args, _DTYPES[q.dtype], *shape, *plan)
    else:
        FLASH_FMA(q.device, *args, _DTYPES[q.dtype], *shape)
    return out


def needs_grad(q, k, v) -> bool:
    """Whether autograd would record a call on q, k and v."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, softcap, impl)``: the forward is
    ``impl(q, k, v, causal=, window=, softcap=)`` (on the card
    :func:`flash_attention_cuda`), the backward the vector-Jacobian
    product of the plain version, recomputed in f32 from the saved q, k and
    v. The gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, impl):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return impl(q, k, v, causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        causal, window, softcap = ctx.mask
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
            out = ref.flash_attention(*ins, causal=causal, window=window, softcap=softcap)
            grads = iter(torch.autograd.grad(out, [x for x in ins if x.requires_grad], grad))
        return (*(next(grads) if n else None for n in need), None, None, None, None)
