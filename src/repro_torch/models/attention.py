"""Grouped-query attention with RoPE, sliding windows, softcap and KV caches
(``repro.models.attention``): ``forward`` (training and prefill
self-attention), ``decode`` (one token against a cache), and whisper's
``bidirectional`` (encoder self-attention), ``cross`` (decoder over the
encoder) and ``encode_kv`` (the cross K/V).

Parameters have the reference's names and shapes with a leading client
axis: ``wq`` (m, D, Hq, Dh), ``wk``/``wv`` (m, D, Hkv, Dh), ``wo``
(m, Hq·Dh, D), biases (m, H, Dh); activations are (m, B, S, D). One
model is m = 1. Clients fold into the attention kernel's batch axis.

Every entry point reaches :func:`repro_torch.kernels.ops.flash_attention`:
``forward`` causal (with the layer's window), ``decode`` over the valid
prefix of the cache with no mask, ``bidirectional`` and ``cross`` with no
mask (``cross`` over the encoder's Sk ≠ Sq keys). Where autograd records
a call (a train step), the kernel runs inside ``FlashAttentionFn``, whose
backward is the plain version's, so q, k and v get their gradients on the
card.

Cache convention, as the reference's: ``{"k": (m, B, L, Hkv, Dh), "v",
"pos": (m, L) int32}`` with ``pos[w]`` the absolute position in slot w
(−1 empty). Global layers use L = max context and write slot ``pos``;
window layers use L = min(window, max_len) and write slot ``pos % L``.
``decode`` writes the cache in place (the reference returns a new one).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import fan_in_init, matmul, rope


@functools.lru_cache(maxsize=None)
def plan_heads(num_heads: int, num_kv: int, pad_to: int):
    """Head-padding plan for tensor-parallel deployment (copied from the
    reference): repeat-KV or zero-pad so the head counts divide ``pad_to``,
    whichever wastes less KV cache. Returns
    (hq_eff, hkv_eff, q_of_slot, kv_of_slot), −1 marking a zero slot."""
    if pad_to <= 1 or num_kv % pad_to == 0:
        return (num_heads, num_kv, tuple(range(num_heads)),
                tuple(range(num_kv)))
    g0 = num_heads // num_kv
    r_rep = pad_to // math.gcd(num_kv, pad_to)
    cost_rep = r_rep  # cache multiplier
    nkv_pad = -(-num_kv // pad_to) * pad_to
    cost_pad = nkv_pad / num_kv
    if cost_rep <= cost_pad:
        hkv = num_kv * r_rep
        g = -(-g0 // r_rep)
        kv_of = tuple(j // r_rep for j in range(hkv))
        q_of = [-1] * (hkv * g)
        for k in range(num_kv):
            for i in range(g0):
                t, gg = i % r_rep, i // r_rep
                q_of[(k * r_rep + t) * g + gg] = k * g0 + i
    else:
        hkv = nkv_pad
        g = g0
        kv_of = tuple(k if k < num_kv else -1 for k in range(hkv))
        q_of = [-1] * (hkv * g)
        for k in range(num_kv):
            for gg in range(g0):
                q_of[k * g + gg] = k * g0 + gg
    return hkv * g, hkv, tuple(q_of), kv_of


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_base: float = 10000.0
    rope_pct: float = 1.0  # stablelm2 uses partial rotary (25%)
    logit_softcap: float | None = None
    use_rope: bool = True
    pad_to: int = 1  # model-axis size the deployment pads heads for

    @property
    def plan(self):
        return plan_heads(self.num_heads, self.num_kv_heads, self.pad_to)

    @property
    def hq_eff(self):
        return self.plan[0]

    @property
    def hkv_eff(self):
        return self.plan[1]

    @property
    def q_groups(self):
        return self.hq_eff // self.hkv_eff

    @property
    def rope_dim(self):
        rd = int(self.head_dim * self.rope_pct)
        return rd - rd % 2


def _expand_heads(w, of_slot, axis):
    """Scatter original heads into padded slots (−1 → zeros). Exact."""
    slots = torch.tensor([max(s, 0) for s in of_slot], device=w.device)
    mask_shape = [1] * w.dim()
    mask_shape[axis] = len(of_slot)
    mask = torch.tensor([s >= 0 for s in of_slot], dtype=w.dtype,
                        device=w.device).reshape(mask_shape)
    return torch.index_select(w, axis, slots) * mask


def init(gen, cfg: AttnConfig, dtype=torch.float32, device=None):
    """One model's attention weights (no client axis), in the reference's
    shapes, on ``device`` (CUDA when None); matches the reference in
    distribution only."""
    device = resolve_device(device)
    hq, hkv, q_of, kv_of = cfg.plan
    wq = fan_in_init(gen, (cfg.d_model, cfg.num_heads, cfg.head_dim), dtype, device)
    wk = fan_in_init(gen, (cfg.d_model, cfg.num_kv_heads, cfg.head_dim), dtype, device)
    wv = fan_in_init(gen, (cfg.d_model, cfg.num_kv_heads, cfg.head_dim), dtype, device)
    wo = fan_in_init(gen, (cfg.num_heads, cfg.head_dim, cfg.d_model), dtype, device)
    if cfg.pad_to > 1:
        wq, wk, wv = _expand_heads(wq, q_of, 1), _expand_heads(wk, kv_of, 1), \
            _expand_heads(wv, kv_of, 1)
        wo = _expand_heads(wo, q_of, 0)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo.reshape(hq * cfg.head_dim, cfg.d_model)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, cfg.head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, cfg.head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, cfg.head_dim), dtype=dtype, device=device)
    return p


def _project(x, w, b):
    """x (m, B, S, D) @ w (m, D, H, Dh) [+ b (m, H, Dh)] -> (m, B, S, H, Dh)."""
    m, _, h, dh = w.shape
    y = matmul(x, w.reshape(m, -1, h * dh)).unflatten(-1, (h, dh))
    return y if b is None else y + b[:, None, None]


def _qkv(p, x, cfg: AttnConfig, positions):
    """q (m, B, S, Hq, Dh), k and v (m, B, S, Hkv, Dh); positions (B, S)."""
    q = _project(x, p["wq"], p["bq"] if cfg.qkv_bias else None)
    k, v = encode_kv(p, x, cfg)
    if cfg.use_rope:
        q = rope(q, positions, base=cfg.rope_base, rope_dim=cfg.rope_dim)
        k = rope(k, positions, base=cfg.rope_base, rope_dim=cfg.rope_dim)
    return q, k, v


def _fold(t):
    """(m, B, S, H, Dh) -> the kernel's (m·B, H, S, Dh) view."""
    return t.flatten(0, 1).transpose(1, 2)


def _unfold(out, m):
    """The kernel's (m·B, Hq, S, Dh) -> (m, B, S, Hq·Dh)."""
    mb, hq, s, dh = out.shape
    return out.transpose(1, 2).reshape(m, mb // m, s, hq * dh)


def forward(p, x, positions, cfg: AttnConfig, *, window: int | None = None):
    """Training/prefill self-attention over positions 0..S−1 (top-left
    causal, as the reference's ``j <= i`` on ``arange`` positions).
    Returns (out (m, B, S, D), (k, v)), k and v (m, B, S, Hkv, Dh)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(_fold(q), _fold(k), _fold(v), causal=True, window=window,
                              softcap=cfg.logit_softcap)
    return matmul(_unfold(out, x.shape[0]), p["wo"]), (k, v)


def bidirectional(p, x, positions, cfg: AttnConfig):
    """Encoder self-attention, no mask. Returns out (m, B, S, D) only."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = ops.flash_attention(_fold(q), _fold(k), _fold(v), causal=False,
                              softcap=cfg.logit_softcap)
    return matmul(_unfold(out, x.shape[0]), p["wo"])


def cross(p, x, enc_kv, cfg: AttnConfig):
    """Cross-attention of x (m, B, S, D) over precomputed encoder K/V,
    each (m, B, T, Hkv, Dh): no mask, no rope. Only q is projected from x
    (the reference's ``_qkv`` also projects k and v and drops them)."""
    q = _project(x, p["wq"], p["bq"] if cfg.qkv_bias else None)
    k, v = enc_kv
    out = ops.flash_attention(_fold(q), _fold(k), _fold(v), causal=False,
                              softcap=cfg.logit_softcap)
    return matmul(_unfold(out, x.shape[0]), p["wo"])


def encode_kv(p, enc_out, cfg: AttnConfig):
    """K and V (m, B, T, Hkv, Dh) of enc_out (m, B, T, D), with their biases."""
    bias = cfg.qkv_bias
    return (_project(enc_out, p["wk"], p["bk"] if bias else None),
            _project(enc_out, p["wv"], p["bv"] if bias else None))


def init_cache(clients, batch, length, cfg: AttnConfig, dtype=torch.bfloat16, device=None):
    """An empty cache of ``clients`` models on ``device`` (CUDA when None):
    k and v (clients, B, L, Hkv, Dh) zeros, pos (clients, L) of -1."""
    device = resolve_device(device)
    return {
        "k": torch.zeros((clients, batch, length, cfg.hkv_eff, cfg.head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((clients, batch, length, cfg.hkv_eff, cfg.head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((clients, length), -1, dtype=torch.int32, device=device),
    }


def decode(p, x, cache, pos: int, cfg: AttnConfig, *, window: int | None = None):
    """One-token decode at absolute position ``pos`` (a host int). x: (m, B, 1, D).

    Writes k and v into slot ``pos`` (global) or ``pos % L`` (window) in
    place, then attends over the valid slots. Filled in order from
    position 0, those are always the prefix [0, n), n = min(pos + 1, L):
    a rolling cache that has wrapped holds only positions inside the
    window, and attention does not depend on the order of its keys. So the
    kernel runs unmasked over the prefix, with no device sync.
    Returns (out (m, B, 1, D), cache).
    """
    length = cache["k"].shape[2]
    if window is None and pos >= length:
        raise ValueError(f"decode: position {pos} does not fit a cache of length {length}")
    positions = torch.full((x.shape[1], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    slot = pos % length if window is not None else pos
    cache["k"][:, :, slot] = k[:, :, 0]
    cache["v"][:, :, slot] = v[:, :, 0]
    cache["pos"][:, slot] = pos
    n = min(pos + 1, length)
    out = ops.flash_attention(_fold(q), _fold(cache["k"][:, :, :n]),
                              _fold(cache["v"][:, :, :n]), causal=False,
                              softcap=cfg.logit_softcap)
    return matmul(_unfold(out, x.shape[0]), p["wo"]), cache
