"""Whisper-style encoder-decoder transformer (``repro.models.whisper``).

The mel-spectrogram and conv front end is a stub, as in the reference:
``batch["frames"]`` holds precomputed frame embeddings (m, B, T_enc, D).
The module is the transformer: a pre-LN bidirectional encoder with
sinusoidal positions and a final LayerNorm; a decoder with learned
positions, causal self-attention (cached), cross-attention over the
encoder's output in every layer and GELU MLPs; the read-out tied to the
embedding. No RoPE anywhere (arXiv:2212.04356).

Params layout, leaf for leaf the reference's: embed.table (V, D),
pos_embed (max_pos, D), enc_blocks.* stacked over the encoder layers,
enc_final_norm, dec_blocks.* stacked over the decoder layers, final_norm.
``init`` builds one model; every other function runs m models at once,
each leaf with a leading client axis (m, ...), activations (m, B, S, D),
as :mod:`repro_torch.models.transformer` does.

Caches, leaves (m, L, ...) over the decoder's L layers: ``{"self": {"k",
"v" (m, L, B, S, Hkv, Dh), "pos" (m, L, S) int32}, "cross_kv" (m, L, 2, B,
T_enc, Hkv, Dh)}``; a prefill's self caches hold k and v alone, as the
reference's. Each decoder layer's cross K/V is computed once a forward
(the reference computes it twice when it returns the caches).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import layer_views, stack, tree_map
from repro_torch.device import check_generator, resolve_device
from repro_torch.models import attention, transformer
from repro_torch.models.attention import AttnConfig
from repro_torch.models.layers import (
    embed_init,
    embed_logits,
    embed_lookup,
    layernorm,
    layernorm_init,
    mlp_apply,
    mlp_init,
    normal_init,
    sinusoidal_positions,
)


def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=True,
        use_rope=False,
        pad_to=cfg.head_pad,
    )


def _init_enc_layer(gen, cfg, dtype, device):
    return {
        "ln_attn": layernorm_init(cfg.d_model, dtype, device),
        "attn": attention.init(gen, attn_config(cfg), dtype, device),
        "ln_mlp": layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype, device),
    }


def _init_dec_layer(gen, cfg, dtype, device):
    return {
        "ln_self": layernorm_init(cfg.d_model, dtype, device),
        "self_attn": attention.init(gen, attn_config(cfg), dtype, device),
        "ln_cross": layernorm_init(cfg.d_model, dtype, device),
        "cross_attn": attention.init(gen, attn_config(cfg), dtype, device),
        "ln_mlp": layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device=None):
    """One model's params in ``cfg.param_dtype`` on ``device`` (CUDA when
    None), drawn from ``gen``, a generator on that device (``ValueError``
    otherwise); layers stacked on their layer axis as the reference's
    ``vmap`` stacks them. Matches the reference in distribution only. On
    the ``meta`` device ``gen`` may be None and nothing is drawn."""
    device = resolve_device(device)
    check_generator("whisper.init", gen, device)
    dtype = cfg.param_tdtype
    return {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "pos_embed": normal_init(gen, (cfg.max_pos, cfg.d_model), 0.01, dtype, device),
        "enc_blocks": stack([_init_enc_layer(gen, cfg, dtype, device)
                             for _ in range(cfg.encoder_layers)]),
        "enc_final_norm": layernorm_init(cfg.d_model, dtype, device),
        "dec_blocks": stack([_init_dec_layer(gen, cfg, dtype, device)
                             for _ in range(cfg.num_layers)]),
        "final_norm": layernorm_init(cfg.d_model, dtype, device),
    }


def _run(body, h, p, cfg: ModelConfig):
    """body(h, p) under a plain non-reentrant checkpoint where ``cfg.remat``
    and autograd records it (``transformer.records``; the reference's
    ``jax.checkpoint`` of the scanned body), else as it is."""
    if cfg.remat and transformer.records(h, p):
        return checkpoint(body, h, p, use_reentrant=False)
    return body(h, p)


def encode(params, frames, cfg: ModelConfig):
    """frames (m, B, T_enc, D) stub-frontend embeddings -> (m, B, T_enc, D)."""
    acfg = attn_config(cfg)
    h = frames.to(cfg.act_tdtype)
    t = h.shape[2]
    h = h + sinusoidal_positions(t, cfg.d_model, h.dtype, h.device)
    positions = torch.arange(t, device=h.device)[None]

    def body(h, p):
        x = layernorm(p["ln_attn"], h)
        h = h + attention.bidirectional(p["attn"], x, positions, acfg)
        return h + mlp_apply(p["mlp"], layernorm(p["ln_mlp"], h), "gelu")

    for p in layer_views(params["enc_blocks"], cfg.encoder_layers):
        h = _run(body, h, p, cfg)
    return layernorm(params["enc_final_norm"], h)


def _dec_layer(p, h, positions, cross_kv, cfg: ModelConfig, *, cache=None, pos=None):
    """One decoder layer: causal self-attention (``forward`` without a
    cache, ``decode`` at ``pos`` with one), cross-attention over
    ``cross_kv`` = (k, v), the gelu MLP. Returns (h, the self cache)."""
    acfg = attn_config(cfg)
    x = layernorm(p["ln_self"], h)
    if cache is None:
        out, (k, v) = attention.forward(p["self_attn"], x, positions, acfg)
        cache = {"k": k, "v": v}
    else:
        out, cache = attention.decode(p["self_attn"], x, cache, pos, acfg)
    h = h + out
    h = h + attention.cross(p["cross_attn"], layernorm(p["ln_cross"], h), cross_kv, acfg)
    h = h + mlp_apply(p["mlp"], layernorm(p["ln_mlp"], h), "gelu")
    return h, cache


def decode_train(params, tokens, enc_out, cfg: ModelConfig, *, return_cache: bool = False,
                 last_only: bool = False):
    """Teacher-forced decoder forward of tokens (m, B, S) over enc_out
    (m, B, T_enc, D) -> logits f32 (m, B, S, V), or (m, B, 1, V) with
    ``last_only`` [, caches {"self": {"k", "v"}, "cross_kv"}]."""
    h = embed_lookup(params["embed"], tokens).to(cfg.act_tdtype)
    s = tokens.shape[-1]
    h = h + params["pos_embed"][:, None, :s].to(h.dtype)
    positions = torch.arange(s, device=h.device)[None]
    acfg = attn_config(cfg)

    def body(h, p):
        kv = attention.encode_kv(p["cross_attn"], enc_out, acfg)
        return _dec_layer(p, h, positions, kv, cfg)[0]

    selfs, crosses = [], []
    for p in layer_views(params["dec_blocks"], cfg.num_layers):
        if not return_cache:
            h = _run(body, h, p, cfg)
            continue
        kv = attention.encode_kv(p["cross_attn"], enc_out, acfg)
        h, self_cache = _dec_layer(p, h, positions, kv, cfg)
        selfs.append(self_cache)
        crosses.append(torch.stack(kv, dim=1))
    if last_only:
        h = h[:, :, -1:]
    logits = _masked_logits(params, layernorm(params["final_norm"], h), cfg)
    if not return_cache:
        return logits
    return logits, {"self": stack(selfs, dim=1), "cross_kv": torch.stack(crosses, dim=1)}


def _masked_logits(params, h, cfg: ModelConfig):
    logits = embed_logits(params["embed"], h).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(params, batch, cfg: ModelConfig, *, return_cache: bool = False,
            last_only: bool = False):
    """``batch["frames"]`` (m, B, T_enc, D) through the encoder, then
    ``batch["tokens"]`` (m, B, S) through the decoder -> logits f32
    (m, B, S, V) [, prefill caches]; ``last_only`` reads out the last
    position alone, (m, B, 1, V), as a prefill step does. The reference
    also returns a zero aux loss; this returns none (as
    ``transformer.forward``)."""
    enc = encode(params, batch["frames"], cfg)
    return decode_train(params, batch["tokens"], enc, cfg, return_cache=return_cache,
                        last_only=last_only)


def loss_fn(params, batch, cfg: ModelConfig):
    """(m,) f32: each model's mean NLL of ``batch["labels"]`` (m, B, S)."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"].long()  # the reference's int32 labels too
    nll = F.cross_entropy(logits.flatten(0, -2), labels.flatten(), reduction="none")
    return nll.view(labels.shape[0], -1).mean(dim=1)


def init_cache(cfg: ModelConfig, clients: int, batch: int, max_len: int, device=None, *,
               enc_out=None, params=None):
    """Empty decoder self caches of m = ``clients`` models (k, v (m, L, B,
    max_len, Hkv, Dh) in ``cfg.act_dtype``, pos (m, L, max_len) of −1) on
    ``device`` (CUDA when None), and the cross K/V: each decoder layer's
    ``encode_kv`` of ``enc_out`` (m, B, T_enc, D) under ``params`` where
    given, else zeros (m, L, 2, B, cfg.encoder_seq, Hkv, Dh), as the
    reference."""
    device = resolve_device(device)
    acfg = attn_config(cfg)
    layers = cfg.num_layers
    one = attention.init_cache(clients * layers, batch, max_len, acfg, cfg.act_tdtype, device)
    self_caches = tree_map(lambda x: x.unflatten(0, (clients, layers)), one)
    if enc_out is not None:
        cross = torch.stack([torch.stack(attention.encode_kv(p["cross_attn"], enc_out, acfg),
                                         dim=1)
                             for p in layer_views(params["dec_blocks"], layers)], dim=1)
    else:
        cross = torch.zeros((clients, layers, 2, batch, cfg.encoder_seq, acfg.hkv_eff,
                             cfg.resolved_head_dim), dtype=cfg.act_tdtype, device=device)
    return {"self": self_caches, "cross_kv": cross}


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig):
    """One-token decode of m models with cached cross K/V. tokens (m, B, 1);
    ``pos`` a host int below ``cfg.max_pos`` (``ValueError`` past it, where
    the reference clamps its position lookup). Writes the self caches in
    place and returns (logits (m, B, 1, V) f32, caches)."""
    if not 0 <= pos < cfg.max_pos:
        raise ValueError(f"whisper.decode_step: position {pos} is outside the "
                         f"{cfg.max_pos}-row position table")
    h = embed_lookup(params["embed"], tokens).to(cfg.act_tdtype)
    h = h + params["pos_embed"][:, None, pos:pos + 1].to(h.dtype)
    layers = cfg.num_layers
    for p, cache, cross in zip(layer_views(params["dec_blocks"], layers),
                               layer_views(caches["self"], layers),
                               layer_views(caches["cross_kv"], layers)):
        h, _ = _dec_layer(p, h, None, (cross[:, 0], cross[:, 1]), cfg, cache=cache, pos=pos)
    return _masked_logits(params, layernorm(params["final_norm"], h), cfg), caches
