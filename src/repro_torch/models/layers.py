"""Shared transformer building blocks (``repro.models.layers``), in torch.

Functions take the reference's parameter dicts and shapes. Every one of
them broadcasts over leading axes, so a client axis in front of the
weights (``(m, d_model, d_ff)``) and of the activations (``(m, B, S, D)``)
passes through as a batch of per-client products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- init utils
def normal_init(gen, shape, scale=0.02, dtype=torch.float32, device=None):
    """``scale · N(0, 1)`` of ``shape``, drawn in ``dtype`` on ``device``.

    Matches the reference in distribution only (its draws are jax's)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, scale, generator=gen)


def fan_in_init(gen, shape, dtype=torch.float32, device=None):
    return normal_init(gen, shape, shape[0] ** -0.5, dtype, device)


# ---------------------------------------------------------------- norms
def rmsnorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps=1e-6):
    """Gemma-style RMSNorm with ``(1 + scale)``: zero init is the identity."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + _bcast(p["scale"], x).to(torch.float32))).to(x.dtype)


def layernorm_init(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, *, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * _bcast(p["scale"], x).to(torch.float32)
            + _bcast(p["bias"], x).to(torch.float32)).to(x.dtype)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


def _bcast(w, x):
    """A per-feature vector (..., D), with or without a client axis, shaped
    to broadcast against activations x (..., S, D): leading axes of w line
    up with leading axes of x."""
    extra = x.dim() - w.dim()
    return w.reshape(w.shape[:-1] + (1,) * extra + w.shape[-1:])


# ---------------------------------------------------------------- RoPE
def rope(x, positions, *, base=10000.0, rope_dim=None):
    """Rotary embedding, rotate-half layout over the first ``rope_dim``
    features. x: (..., S, H, Dh); positions: (..., S), broadcast against
    x's leading axes."""
    dh = x.shape[-1]
    rd = rope_dim or dh
    half = rd // 2
    freq = base ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rd < dh else out


# ---------------------------------------------------------------- MLPs
def mlp_init(gen, d_model, d_ff, kind, dtype=torch.float32, device=None):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_up": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_down": fan_in_init(gen, (d_ff, d_model), dtype, device),
        }
    if kind == "gelu":  # whisper-style 2-layer MLP with bias
        return {
            "w_up": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": fan_in_init(gen, (d_ff, d_model), dtype, device),
            "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
        }
    raise ValueError(kind)


def matmul(x, w):
    """x (..., S, K) @ w (K, N), or per client: x (m, ..., S, K) @ w (m, K, N)
    as one batched product over the client axis.

    bf16 products accumulate and reduce in f32, as the reference's do: a
    bf16 product on the card first turns cuBLAS's reduced-precision bf16
    reduction off. That switch is process-wide, so it also holds for the
    products autograd issues in the backward, which runs after this."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if w.dim() == 2:
        return x @ w
    lead = x.shape[:-1]
    y = torch.bmm(x.reshape(w.shape[0], -1, x.shape[-1]), w)
    return y.reshape(lead + (w.shape[-1],))


def mlp_apply(p, x, kind):
    if kind == "swiglu":
        act = F.silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
        return matmul(act, p["w_down"])
    if kind == "geglu":
        act = F.gelu(matmul(x, p["w_gate"]), approximate="tanh") * matmul(x, p["w_up"])
        return matmul(act, p["w_down"])
    if kind == "gelu":  # tanh form, as the reference's jax.nn.gelu(approximate=True)
        up = F.gelu(matmul(x, p["w_up"]) + _bcast(p["b_up"], x), approximate="tanh")
        return matmul(up, p["w_down"]) + _bcast(p["b_down"], x)
    raise ValueError(kind)


# ---------------------------------------------------------------- softcap
def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- embedding
def embed_init(gen, vocab, d_model, dtype=torch.float32, device=None):
    return {"table": normal_init(gen, (vocab, d_model), 0.02, dtype, device)}


def embed_lookup(p, tokens, *, scale=None):
    """Rows of the table; per client, table (m, V, D) and tokens (m, ...).
    ``scale`` is rounded to the table's dtype first, as the reference does."""
    table = p["table"]
    if table.dim() == 2:
        y = table[tokens]
    else:
        m = table.shape[0]
        flat = tokens.reshape(m, -1)
        y = torch.gather(table, 1, flat[..., None].expand(-1, -1, table.shape[-1]))
        y = y.reshape(tokens.shape + (table.shape[-1],))
    if scale is not None:
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return y


def embed_logits(p, h):
    """Tied read-out: (..., D) @ (V, D)ᵀ, per client with a (m, V, D) table."""
    return matmul(h, p["table"].transpose(-1, -2))


def sinusoidal_positions(length, d_model, dtype=torch.float32, device=None):
    """(length, d_model): sin then cos of pos / 10000^(2i / d_model), computed
    in f32 in the reference's order of operations, then cast to ``dtype``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
