"""Config-driven decoder LM (``repro.models.transformer``), dense family.

Layers repeat in groups of ``cfg.attn_pattern`` (gemma2: a local and a
global layer), and every block leaf is stacked over the groups on its
group axis, as the reference stacks them for ``lax.scan``; here a Python
loop walks the groups.

Params layout, leaf for leaf the reference's:
  embed.table (V, D), final_norm, lm_head.w (D, V) when untied,
  blocks.l{i}.* with every leaf stacked over num_groups.
``init`` builds one model with that layout. ``forward``, ``decode_step``
and ``init_cache`` run m models at once: every leaf carries a leading
client axis (m, ...), as the reference's ``vmap`` over clients would see
it, and the inputs are (m, B, S). One model is m = 1
(:mod:`repro_torch.models.registry` adds and drops that axis).

``loss_fn`` gives each of the m models its own mean next-token NLL, so
autograd of their sum gives every client the gradient of its own loss
(the clients' params are disjoint): the reference's
``vmap(value_and_grad(loss))``. With ``cfg.remat`` each layer group runs
under ``torch.utils.checkpoint`` (non-reentrant) whenever autograd records
it, as the reference's ``jax.checkpoint`` of the scanned body.

Families moe, ssm, hybrid, vlm and audio, and ``first_dense > 0``, raise
``NotImplementedError`` (the other model families, ROADMAP queue A).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.attention import AttnConfig
from repro_torch.models.layers import (
    embed_init,
    embed_logits,
    embed_lookup,
    fan_in_init,
    make_norm,
    matmul,
    mlp_apply,
    mlp_init,
    softcap,
)


def _check(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.first_dense:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (first_dense={cfg.first_dense}) is not ported; "
            "the port has the dense family; the other model families are in ROADMAP queue A")


# --------------------------------------------------------------- sub-configs
def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_base=cfg.rope_base,
        rope_pct=cfg.rope_pct,
        logit_softcap=cfg.attn_softcap,
        pad_to=cfg.head_pad,
    )


def _group_slots(cfg: ModelConfig):
    """The layer kinds inside one group."""
    return tuple(f"attn_{a}" for a in cfg.attn_pattern)


def _window(cfg: ModelConfig, kind: str):
    return cfg.window if kind.endswith("local") else None


# --------------------------------------------------------------- init
def _init_attn_layer(gen, cfg: ModelConfig, dtype, device):
    ninit, _ = make_norm(cfg.norm)
    p = {
        "ln_attn": ninit(cfg.d_model, dtype, device),
        "attn": attention.init(gen, attn_config(cfg), dtype, device),
        "ln_mlp": ninit(cfg.d_model, dtype, device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }
    if cfg.post_norms:
        p["ln_post_attn"] = ninit(cfg.d_model, dtype, device)
        p["ln_post_mlp"] = ninit(cfg.d_model, dtype, device)
    return p


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init(gen: torch.Generator, cfg: ModelConfig, device=None):
    """One model's params in ``cfg.param_dtype`` on ``device`` (CUDA when
    None), drawn from ``gen``, a generator on that device (``ValueError``
    otherwise). Matches the reference in distribution only."""
    _check(cfg)
    device = resolve_device(device)
    if gen.device.type != device.type or (device.index is not None
                                          and gen.device.index != device.index):
        raise ValueError(f"transformer.init: the generator lives on {gen.device}, "
                         f"the params on {device}")
    dtype = cfg.param_tdtype
    ninit, _ = make_norm(cfg.norm)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "final_norm": ninit(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": fan_in_init(gen, (cfg.d_model, cfg.padded_vocab), dtype,
                                              device)}
    slots = _group_slots(cfg)
    params["blocks"] = _stack([
        {f"l{i}": _init_attn_layer(gen, cfg, dtype, device) for i in range(len(slots))}
        for _ in range(cfg.num_groups)])
    return params


# --------------------------------------------------------------- forward
def _apply_attn_layer(p, h, positions, cfg: ModelConfig, kind: str, *, cache=None, pos=None):
    """One attention + MLP layer on h (m, B, S, D); returns (h, cache),
    the cache being (k, v) of the layer in a forward and the written
    cache in a decode."""
    _, napply = make_norm(cfg.norm)
    acfg = attn_config(cfg)
    x = napply(p["ln_attn"], h)
    if cache is None:
        attn_out, new_cache = attention.forward(p["attn"], x, positions, acfg,
                                                window=_window(cfg, kind))
    else:
        attn_out, new_cache = attention.decode(p["attn"], x, cache, pos, acfg,
                                               window=_window(cfg, kind))
    if cfg.post_norms:
        attn_out = napply(p["ln_post_attn"], attn_out)
    h = h + attn_out
    mlp_out = mlp_apply(p["mlp"], napply(p["ln_mlp"], h), cfg.mlp)
    if cfg.post_norms:
        mlp_out = napply(p["ln_post_mlp"], mlp_out)
    return h + mlp_out, new_cache


def _apply_group(group_p, h, positions, cfg: ModelConfig, *, caches=None, pos=None):
    """One group of layers; ``caches`` keyed like the group's params."""
    new_caches = {}
    for i, slot in enumerate(_group_slots(cfg)):
        key = f"l{i}"
        h, new_caches[key] = _apply_attn_layer(
            group_p[key], h, positions, cfg, slot,
            cache=None if caches is None else caches[key], pos=pos)
    return h, new_caches


# the matrix products remat_policy="dots" keeps (the reference's
# dots_saveable): every other op of a group is recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, cfg: ModelConfig):
    """Per-layer-group remat: ``body`` under a non-reentrant checkpoint,
    keeping only its inputs ("full") or also its matrix products ("dots")
    for the backward. "save_moe" names the MoE output, which the dense
    family does not have."""
    if not cfg.remat:
        return body
    if cfg.remat_policy == "save_moe":
        raise NotImplementedError(f"{cfg.name}: remat_policy 'save_moe' saves the MoE layers' "
                                  "outputs; the MoE family is in ROADMAP queue A")
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *a: checkpoint(body, *a, use_reentrant=False, **kw)


def _groups(tree, cfg: ModelConfig):
    """Per-group views of a (m, G, ...) stacked tree."""
    for g in range(cfg.num_groups):
        yield tree_map(lambda x, g=g: x[:, g], tree)


def _embed_inputs(params, tokens, cfg: ModelConfig):
    scale = cfg.d_model ** 0.5 if cfg.emb_scale else None
    return embed_lookup(params["embed"], tokens, scale=scale).to(cfg.act_tdtype)


def _readout(params, h, cfg: ModelConfig):
    _, napply = make_norm(cfg.norm)
    h = napply(params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = embed_logits(params["embed"], h)
    else:
        logits = matmul(h, params["lm_head"]["w"])
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded vocab rows exactly
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(params, batch, cfg: ModelConfig, *, return_cache: bool = False,
            last_only: bool = False):
    """Full-sequence forward of m models on tokens (m, B, S) ->
    logits f32 (m, B, S, V) [, prefill caches].

    ``last_only`` reads out the last position alone, (m, B, 1, V): what
    a prefill step returns, without the (m, B, S, V) logits. The caches
    are ``{"blocks": {"l{i}": {"k", "v"}}}`` with k, v (m, G, B, S, Hkv, Dh).
    """
    _check(cfg)
    tokens = batch["tokens"]
    h = _embed_inputs(params, tokens, cfg)
    positions = torch.arange(tokens.shape[-1], device=h.device)[None]
    per_group = []
    remat = None  # built at the first group autograd records
    for group_p in _groups(params["blocks"], cfg):
        if cfg.remat and not return_cache and torch.is_grad_enabled() and (
                h.requires_grad or any(x.requires_grad for x in leaves(group_p))):
            remat = remat or _remat(
                lambda h, group_p: _apply_group(group_p, h, positions, cfg)[0], cfg)
            h = remat(h, group_p)
            continue
        h, kv = _apply_group(group_p, h, positions, cfg)
        if return_cache:
            per_group.append(kv)
    if last_only:
        h = h[:, :, -1:]
    logits = _readout(params, h, cfg)
    if not return_cache:
        return logits
    caches = {key: {"k": torch.stack([g[key][0] for g in per_group], dim=1),
                    "v": torch.stack([g[key][1] for g in per_group], dim=1)}
              for key in per_group[0]}
    return logits, {"blocks": caches}


def loss_fn(params, batch, cfg: ModelConfig, *, aux_weight=0.01):
    """(m,) f32: each model's mean next-token NLL over its (B, S) tokens
    ``batch["tokens"]`` against ``batch["labels"]`` (m, B, S). The dense
    family has no auxiliary loss, so ``aux_weight`` multiplies 0 and the
    loss is the NLL alone, as in the reference."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"]
    m = labels.shape[0]
    nll = F.cross_entropy(logits.flatten(0, -2), labels.flatten(), reduction="none")
    return nll.view(m, -1).mean(dim=1)


# --------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, clients: int, batch: int, max_len: int, device=None):
    """Empty caches of m = ``clients`` models, leaves (m, G, ...): k and v
    (m, G, B, L, Hkv, Dh) in ``cfg.act_dtype``, pos (m, G, L) int32; L is
    max_len, or min(window, max_len) for a window layer; on ``device``,
    CUDA when None."""
    _check(cfg)
    device = resolve_device(device)
    acfg = attn_config(cfg)
    out = {}
    for i, slot in enumerate(_group_slots(cfg)):
        window = _window(cfg, slot)
        length = min(window, max_len) if window else max_len
        one = attention.init_cache(clients * cfg.num_groups, batch, length, acfg,
                                   cfg.act_tdtype, device)
        out[f"l{i}"] = tree_map(lambda x: x.unflatten(0, (clients, cfg.num_groups)), one)
    return {"blocks": out}


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig):
    """One-token decode of m models. tokens (m, B, 1); ``pos`` a host int.

    Writes the caches in place and returns (logits (m, B, 1, V) f32,
    caches).
    """
    _check(cfg)
    h = _embed_inputs(params, tokens, cfg)
    for group_p, group_c in zip(_groups(params["blocks"], cfg), _groups(caches["blocks"], cfg)):
        h, _ = _apply_group(group_p, h, None, cfg, caches=group_c, pos=pos)
    return _readout(params, h, cfg), caches
