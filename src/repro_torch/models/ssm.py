"""Mamba2 (SSD, state-space duality) block, chunked (``repro.models.ssm``).

Follows arXiv:2405.21060: a scalar per-head decay a_t = exp(Δ_t·A_h), the
rank-1 state update h_t = a_t·h_{t−1} + Δ_t·(x_t ⊗ B_t) and the readout
y_t = C_t·h_t + D·x_t, in the SSD's chunked form: the intra-chunk terms
are a (Q × Q) masked product, the inter-chunk terms a recurrence over the
chunk states (an f32 loop over the chunks). Decode keeps {conv window,
SSM state} as its cache, O(1) in the context length.

Structure per block: in_proj -> a width-4 depthwise causal conv on
(x, B, C) -> SSD -> gated RMSNorm (silu(z)) -> out_proj.

The port runs m models at once: every leaf carries a leading client axis
(in_proj (m, D, ·), A_log (m, H), ...) and x is (m, B, S, D). ``A_log``,
``D`` and ``dt_bias`` stay f32 in a bf16 model, as in the reference.

Numerics kept from the reference:
  * the conv is W shifted multiply-adds summed in x's dtype (not
    ``conv1d``, which sums in another order);
  * the decay mask puts −inf in the exponent before ``exp``, never on
    exp's output, whose backward would turn inf·0 into NaN;
  * the intra- and inter-chunk products round their operands to the
    compute dtype (x's) and sum in f32 with an f32 result, as the
    reference's ``preferred_element_type``: here f32 products of the
    rounded values (TF32 off, torch's default for matmul);
  * S % Q != 0 raises ``ValueError`` (the reference asserts).
``decode`` writes the state ``h`` (f32) and the conv window into the
cache in place, as attention's decode writes its KV cache.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import fan_in_init, matmul, rmsnorm, rmsnorm_init


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    state: int = 128  # N
    headdim: int = 64  # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def num_heads(self):
        return self.d_inner // self.headdim

    @property
    def conv_channels(self):
        return self.d_inner + 2 * self.state


def init(gen, cfg: SSMConfig, dtype=torch.float32, device=None):
    """One model's block weights (no client axis) in the reference's
    shapes and dtypes, on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    di, n, h = cfg.d_inner, cfg.state, cfg.num_heads
    return {  # in_proj emits [z, x, B, C, dt]
        "in_proj": fan_in_init(gen, (cfg.d_model, 2 * di + 2 * n + h), dtype, device),
        "conv_w": fan_in_init(gen, (cfg.conv_width, cfg.conv_channels), dtype, device),
        "conv_b": torch.zeros((cfg.conv_channels,), dtype=dtype, device=device),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=device),  # A = -exp(A_log)
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(di, dtype, device),
        "out_proj": fan_in_init(gen, (di, cfg.d_model), dtype, device),
    }


def _heads(v, x):
    """A per-head vector (m, H) shaped to broadcast against x (m, B, ..., H)."""
    return v.reshape(v.shape[:1] + (1,) * (x.dim() - 2) + v.shape[1:])


def _split_proj(p, x, cfg: SSMConfig):
    di, n = cfg.d_inner, cfg.state
    zxbcdt = matmul(x, p["in_proj"])
    z, xc, b, c, dt = torch.split(zxbcdt, [di, di, n, n, cfg.num_heads], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + _heads(p["dt_bias"], dt))  # (m, B, S, H)
    return z, xc, b, c, dt


def _causal_conv(xbc, conv_w, conv_b, *, prev=None):
    """Depthwise causal conv along S. xbc (m, B, S, C); conv_w (m, W, C);
    prev (m, B, W − 1, C). Returns (silu(conv + b), the last W − 1 inputs)."""
    w, s = conv_w.shape[1], xbc.shape[2]
    pad = prev if prev is not None else xbc.new_zeros(xbc.shape[:2] + (w - 1, xbc.shape[3]))
    full = torch.cat([pad, xbc], dim=2)
    taps = conv_w[:, :, None, None, :]  # (m, W, 1, 1, C)
    out = sum(full[:, :, i:i + s] * taps[:, i] for i in range(w))
    return F.silu(out + conv_b[:, None, None]), full[:, :, -(w - 1):]


def _mm32(a, b):
    """a @ b in f32 of operands already rounded to the compute dtype: the
    reference's products with ``preferred_element_type=float32``."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def _ssd_chunked(xh, b, c, dt, a_log, cfg: SSMConfig, h0=None):
    """Chunked SSD scan over rows of independent sequences.

    xh (R, S, H, P); b, c (R, S, N); dt (R, S, H) f32; a_log (R, H) f32.
    Returns (y (R, S, H, P) in xh's dtype, h_final (R, H, P, N) f32).
    """
    r, s, h, pdim = xh.shape
    n, q = cfg.state, min(cfg.chunk, s)
    if s % q:
        raise ValueError(f"ssd: the sequence length {s} is not a multiple of the chunk {q}")
    nc = s // q
    cdt = xh.dtype  # compute dtype of the big intra-chunk tensors
    a = -torch.exp(a_log)  # (R, H)

    xc_ = xh.reshape(r, nc, q, h, pdim)
    b_ = b.to(cdt).reshape(r, nc, q, n)
    c_ = c.to(cdt).reshape(r, nc, q, n)
    dt_ = dt.reshape(r, nc, q, h)  # f32
    cum = torch.cumsum(dt_ * a[:, None, None, :], dim=2)  # inclusive log-decay, f32

    # intra-chunk: M[t, s] = exp(cum_t − cum_s)·(C_t·B_s)·dt_s for s <= t
    cb = _mm32(c_, b_.transpose(-1, -2))  # (R, nc, Q, Q) f32
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (R, nc, Q, Q, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = decay.masked_fill(~causal[:, :, None], float("-inf"))
    m = (torch.exp(decay) * cb[..., None] * dt_[:, :, None, :, :]).to(cdt)
    y_intra = _mm32(m.permute(0, 1, 4, 2, 3), xc_.permute(0, 1, 3, 2, 4))  # (R, nc, H, Q, P)

    # chunk summaries: S_c = Σ_s exp(cum_Q − cum_s)·dt_s·(x_s ⊗ B_s), f32
    tail = (torch.exp(cum[:, :, -1:, :] - cum) * dt_).to(cdt)  # (R, nc, Q, H)
    xw = xc_.to(torch.float32) * tail.to(torch.float32)[..., None]  # (R, nc, Q, H, P)
    s_chunk = _mm32(xw.permute(0, 1, 3, 4, 2), b_[:, :, None])  # (R, nc, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (R, nc, H)

    hs = h0 if h0 is not None else torch.zeros((r, h, pdim, n), dtype=torch.float32,
                                               device=xh.device)
    h_prev = []
    for i in range(nc):
        h_prev.append(hs)
        hs = hs * chunk_decay[:, i, :, None, None] + s_chunk[:, i]
    h_prev = torch.stack(h_prev, dim=1)  # (R, nc, H, P, N): the state entering each chunk

    # inter-chunk readout: y_t += C_t · (exp(cum_t)·h_prev)
    ch = _mm32(c_[:, :, None], h_prev.to(cdt).transpose(-1, -2))  # (R, nc, H, Q, P)
    y_inter = ch * torch.exp(cum).to(cdt).to(torch.float32).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(r, s, h, pdim)
    return y.to(xh.dtype), hs


def forward(p, x, cfg: SSMConfig, *, h0=None, conv_prev=None):
    """Full-sequence SSD. x (m, B, S, D) -> (y, cache {"h" (m, B, H, P, N)
    f32, "conv" (m, B, W − 1, C)})."""
    mm, bb, s, _ = x.shape
    di, n, nh = cfg.d_inner, cfg.state, cfg.num_heads
    z, xc, b, c, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(torch.cat([xc, b, c], dim=-1), p["conv_w"], p["conv_b"],
                                   prev=conv_prev)
    xc, b, c = torch.split(xbc, [di, n, n], dim=-1)
    xh = xc.reshape(mm, bb, s, nh, cfg.headdim)
    a_log = p["A_log"].repeat_interleave(bb, dim=0)  # one row a (client, sequence)
    y, h = _ssd_chunked(xh.flatten(0, 1), b.flatten(0, 1), c.flatten(0, 1), dt.flatten(0, 1),
                        a_log, cfg, h0=None if h0 is None else h0.flatten(0, 1))
    y = y.view(mm, bb, s, nh, cfg.headdim)
    y = y + _heads(p["D"], y[..., 0])[..., None].to(y.dtype) * xh
    y = rmsnorm(p["norm"], y.reshape(mm, bb, s, di) * F.silu(z))
    return matmul(y, p["out_proj"]), {"h": h.view(mm, bb, nh, cfg.headdim, n),
                                      "conv": conv_state}


def init_cache(clients, batch, cfg: SSMConfig, dtype=torch.float32, device=None):
    """An empty cache of ``clients`` models on ``device`` (CUDA when None):
    h (clients, B, H, P, N) f32 and conv (clients, B, W − 1, C) zeros."""
    device = resolve_device(device)
    return {
        "h": torch.zeros((clients, batch, cfg.num_heads, cfg.headdim, cfg.state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((clients, batch, cfg.conv_width - 1, cfg.conv_channels),
                            dtype=dtype, device=device),
    }


def decode(p, x, cache, cfg: SSMConfig):
    """One-token step. x (m, B, 1, D) -> (y (m, B, 1, D), cache), the
    cache's h and conv written in place."""
    mm, bb = x.shape[:2]
    di, n, nh = cfg.d_inner, cfg.state, cfg.num_heads
    z, xc, b, c, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(torch.cat([xc, b, c], dim=-1), p["conv_w"], p["conv_b"],
                                   prev=cache["conv"].to(x.dtype))
    xc, b, c = torch.split(xbc, [di, n, n], dim=-1)
    xh = xc.reshape(mm, bb, nh, cfg.headdim).to(torch.float32)
    bt = b[:, :, 0].to(torch.float32)  # (m, B, N)
    ct = c[:, :, 0].to(torch.float32)
    dtt = dt[:, :, 0]  # (m, B, H)
    a = torch.exp(dtt * _heads(-torch.exp(p["A_log"]), dtt))
    h = (cache["h"] * a[..., None, None]
         + dtt[..., None, None] * xh[..., None] * bt[:, :, None, None, :])
    y = torch.matmul(h, ct[:, :, None, :, None])[..., 0] + _heads(p["D"], dtt)[..., None] * xh
    y = y.reshape(mm, bb, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z))
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return matmul(y, p["out_proj"]), cache
