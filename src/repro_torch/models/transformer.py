"""Config-driven decoder LM (``repro.models.transformer``): the dense, MoE,
SSM, hybrid and VLM families.

Layers repeat in groups: ``cfg.attn_pattern`` for dense and MoE (gemma2: a
local and a global layer), one mamba layer for ssm, and (g − 1) mamba
layers plus one shared-attention slot for the zamba2-style hybrid. Every
block leaf is stacked over the groups on its group axis, as the reference
stacks them for ``lax.scan``; here a Python loop walks the groups. The
hybrid's attention weights are stored once (``shared_attn``), with a norm
and a KV cache of its own in every group; kimi's leading dense layer is
``first_block``. The VLM (internvl2) projects ``batch["patch_embeds"]``
(m, B, P, P_in) into the model width and puts them before the token
embeddings, so its positions run over P + S; its decode steps take tokens
alone, as the reference's.

Params layout, leaf for leaf the reference's:
  embed.table (V, D), final_norm, lm_head.w (D, V) when untied,
  first_block?, shared_attn?, projector.{w (P_in, D), b (D,)}?,
  blocks.l{i}.* with every leaf stacked over num_groups.
``init`` builds one model with that layout. ``forward``, ``decode_step``
and ``init_cache`` run m models at once: every leaf carries a leading
client axis (m, ...), as the reference's ``vmap`` over clients would see
it, and the inputs are (m, B, S). One model is m = 1
(:mod:`repro_torch.models.registry` adds and drops that axis).

``forward`` returns the logits (and the prefill caches), not the MoE
layers' auxiliary loss; ``loss_fn`` reads it. ``loss_fn`` gives each of
the m models its own mean next-token NLL plus ``aux_weight`` times its
summed aux loss, so autograd of their sum gives every client the gradient
of its own loss (the clients' params are disjoint): the reference's
``vmap(value_and_grad(loss))``. With ``cfg.remat`` each layer group runs
under ``torch.utils.checkpoint`` (non-reentrant) whenever autograd records
it, as the reference's ``jax.checkpoint`` of the scanned body.

The audio family (whisper, an encoder-decoder) is
:mod:`repro_torch.models.whisper`'s; here it raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import layer_views, leaves, stack, tree_map
from repro_torch.device import check_generator, resolve_device
from repro_torch.models import attention, moe, ssm
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

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not this module's; it has the "
            f"{', '.join(PORTED_FAMILIES)} families, and the audio family is "
            "models/whisper.py's (registry.build dispatches it)")


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


def moe_config(cfg: ModelConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff or cfg.d_ff,
        num_experts=cfg.moe_num_experts,
        top_k=cfg.moe_top_k,
        capacity_factor=cfg.capacity_factor,
        ep_axis=cfg.expert_axis,
    )


def ssm_config(cfg: ModelConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(
        d_model=cfg.d_model,
        state=cfg.ssm_state,
        headdim=cfg.ssm_headdim,
        expand=cfg.ssm_expand,
        chunk=cfg.ssm_chunk,
    )


def _group_slots(cfg: ModelConfig):
    """The layer kinds inside one group."""
    if cfg.family == "ssm":
        return ("mamba",)
    if cfg.family == "hybrid":
        return ("mamba",) * (cfg.hybrid_group - 1) + ("shared_attn",)
    return tuple(f"attn_{a}" for a in cfg.attn_pattern)


def _window(cfg: ModelConfig, kind: str):
    return cfg.window if kind.endswith("local") else None


# --------------------------------------------------------------- init
def _init_attn_layer(gen, cfg: ModelConfig, dtype, device, *, moe_mlp: bool, block=None):
    ninit, _ = make_norm(cfg.norm)
    p = {
        "ln_attn": ninit(cfg.d_model, dtype, device),
        "attn": attention.init(gen, attn_config(cfg), dtype, device),
        "ln_mlp": ninit(cfg.d_model, dtype, device),
    }
    if moe_mlp:
        p["moe"] = moe.init(gen, moe_config(cfg), dtype, device, block=block)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    if cfg.post_norms:
        p["ln_post_attn"] = ninit(cfg.d_model, dtype, device)
        p["ln_post_mlp"] = ninit(cfg.d_model, dtype, device)
    return p


def _init_group(gen, cfg: ModelConfig, dtype, device, block=None):
    ninit, _ = make_norm(cfg.norm)
    p = {}
    for i, slot in enumerate(_group_slots(cfg)):
        if slot == "mamba":
            p[f"l{i}"] = {"ln": ninit(cfg.d_model, dtype, device),
                          "mamba": ssm.init(gen, ssm_config(cfg), dtype, device)}
        elif slot == "shared_attn":
            p[f"l{i}"] = {"ln": ninit(cfg.d_model, dtype, device)}  # weights shared
        else:
            p[f"l{i}"] = _init_attn_layer(
                gen, cfg, dtype, device, moe_mlp=cfg.family == "moe", block=block)
    return p


def init(gen: torch.Generator, cfg: ModelConfig, device=None, *, expert_block=None):
    """One model's params in ``cfg.param_dtype`` (the MoE router and the
    SSM's A_log, D and dt_bias in f32) on ``device`` (CUDA when None),
    drawn from ``gen``, a generator on that device (``ValueError``
    otherwise). Matches the reference in distribution only. On the
    ``meta`` device ``gen`` may be None: nothing is drawn or allocated,
    and the leaves carry the shapes and dtypes alone
    (:func:`repro_torch.launch.steps.abstract_params`).

    ``expert_block`` (a :class:`repro_torch.models.moe.ExpertBlock`) builds
    only those experts and d_ff columns of every MoE layer
    (:func:`repro_torch.models.moe.init`): the rank's block under expert
    parallelism (:func:`repro_torch.launch.sharding.rank_params`). Every
    leaf it builds is the one-rank model's, whatever the block."""
    _check(cfg)
    device = resolve_device(device)
    check_generator("transformer.init", gen, device)
    dtype = cfg.param_tdtype
    ninit, _ = make_norm(cfg.norm)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "final_norm": ninit(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": fan_in_init(gen, (cfg.d_model, cfg.padded_vocab), dtype,
                                              device)}
    params["blocks"] = stack([_init_group(gen, cfg, dtype, device, expert_block)
                              for _ in range(cfg.num_groups)])
    if cfg.first_dense:
        params["first_block"] = _init_attn_layer(gen, cfg, dtype, device, moe_mlp=False)
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_attn_layer(gen, cfg, dtype, device, moe_mlp=False)
    if cfg.family == "vlm":
        params["projector"] = {
            "w": fan_in_init(gen, (cfg.patch_embed_dim, cfg.d_model), dtype, device),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        }
    return params


# --------------------------------------------------------------- forward
def _apply_attn_layer(p, h, positions, cfg: ModelConfig, kind: str, *, cache=None, pos=None,
                      shared=None):
    """One attention + MLP (or MoE) layer on h (m, B, S, D); returns (h,
    cache, aux (m,) f32 or None), the cache being {"k", "v"} of the layer
    in a forward and the written cache in a decode. A shared layer takes
    its input norm from ``p`` and every other weight from ``shared``."""
    _, napply = make_norm(cfg.norm)
    acfg = attn_config(cfg)
    wp = shared if shared is not None else p
    x = napply(p["ln_attn"] if "ln_attn" in p else p["ln"], h)
    if cache is None:
        attn_out, (k, v) = attention.forward(wp["attn"], x, positions, acfg,
                                             window=_window(cfg, kind))
        new_cache = {"k": k, "v": v}
    else:
        attn_out, new_cache = attention.decode(wp["attn"], x, cache, pos, acfg,
                                               window=_window(cfg, kind))
    if cfg.post_norms:
        attn_out = napply(wp["ln_post_attn"], attn_out)
    h = h + attn_out
    aux = None
    if "moe" in wp:
        mlp_out, aux = moe.apply_auto(wp["moe"], napply(wp["ln_mlp"], h), moe_config(cfg))
    else:
        mlp_out = mlp_apply(wp["mlp"], napply(wp["ln_mlp"], h), cfg.mlp)
    if cfg.post_norms:
        mlp_out = napply(wp["ln_post_mlp"], mlp_out)
    return h + mlp_out, new_cache, aux


def _apply_group(group_p, h, positions, cfg: ModelConfig, *, caches=None, pos=None,
                 shared=None):
    """One group of layers; ``caches`` keyed like the group's params.
    Returns (h, caches, aux (m,) f32: the sum of its MoE layers' aux, or
    None where it has none)."""
    new_caches = {}
    aux_total = None
    _, napply = make_norm(cfg.norm)
    for i, slot in enumerate(_group_slots(cfg)):
        key = f"l{i}"
        p = group_p[key]
        cache = None if caches is None else caches[key]
        if slot == "mamba":
            x = napply(p["ln"], h)
            if cache is None:
                out, new_caches[key] = ssm.forward(p["mamba"], x, ssm_config(cfg))
            else:
                out, new_caches[key] = ssm.decode(p["mamba"], x, cache, ssm_config(cfg))
            h = h + out
            continue
        h, new_caches[key], aux = _apply_attn_layer(
            p, h, positions, cfg, "attn_global" if slot == "shared_attn" else slot,
            cache=cache, pos=pos, shared=shared if slot == "shared_attn" else None)
        aux_total = _add_aux(aux_total, aux)
    return h, new_caches, aux_total


def _add_aux(total, aux):
    """The running sum of MoE aux losses, None until a layer gives one: a
    family without MoE layers allocates and adds nothing."""
    return aux if total is None else total if aux is None else total + aux


# the matrix products remat_policy="dots" keeps (the reference's
# dots_saveable): every other op of a group is recomputed in the backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe(ctx, op, *args, **kwargs):
    """Keep each MoE layer's routing, dispatch indices and output, so the
    backward recomputes the rest of the group, the expert products among
    it, but not the dispatch's sort."""
    return (CheckpointPolicy.MUST_SAVE if moe.saving()
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "save_moe": _save_moe}


def _remat(body, cfg: ModelConfig):
    """Per-layer-group remat: ``body`` under a non-reentrant checkpoint,
    keeping only its inputs ("full"), also its matrix products ("dots"), or
    also its MoE layers' routing, dispatch and outputs ("save_moe"; on a
    family without MoE layers it keeps what "full" keeps) for the
    backward."""
    if not cfg.remat:
        return body
    kw = {}
    if cfg.remat_policy in _POLICIES:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _POLICIES[cfg.remat_policy])
    return lambda *a: checkpoint(body, *a, use_reentrant=False, **kw)


def records(h, tree) -> bool:
    """Whether autograd records a layer of activations h and params
    ``tree``: remat applies only there."""
    return torch.is_grad_enabled() and (h.requires_grad
                                        or any(x.requires_grad for x in leaves(tree)))


def _groups(tree, cfg: ModelConfig):
    """Per-group views of a (m, G, ...) stacked tree."""
    return layer_views(tree, cfg.num_groups)


def _embed_tokens(params, tokens, cfg: ModelConfig):
    scale = cfg.d_model ** 0.5 if cfg.emb_scale else None
    return embed_lookup(params["embed"], tokens, scale=scale).to(cfg.act_tdtype)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """The token embeddings (m, B, S, D); the VLM's projected patch
    embeddings, computed in the activation dtype, in front of them."""
    h = _embed_tokens(params, batch["tokens"], cfg)
    if cfg.family == "vlm":
        act = cfg.act_tdtype
        proj = params["projector"]
        h = torch.cat([matmul(batch["patch_embeds"].to(act), proj["w"].to(act))
                       + proj["b"].to(act)[:, None, None], h], dim=2)
    return h


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


def _forward(params, batch, cfg: ModelConfig, *, return_cache: bool, last_only: bool):
    """(logits, aux (m,) f32 or None, prefill caches or None):
    :func:`forward` with the summed aux loss of the MoE layers (None
    without MoE layers)."""
    _check(cfg)
    h = _embed_inputs(params, batch, cfg)
    positions = torch.arange(h.shape[2], device=h.device)[None]
    shared = params.get("shared_attn")
    aux = None
    caches = {}
    if cfg.first_dense:
        h, caches["first_block"], _ = _apply_attn_layer(params["first_block"], h, positions,
                                                        cfg, "attn_global")
    per_group = []
    remat = None  # built at the first group autograd records
    for group_p in _groups(params["blocks"], cfg):
        if cfg.remat and not return_cache and records(h, group_p):
            remat = remat or _remat(
                lambda h, group_p: _apply_group(group_p, h, positions, cfg,
                                                shared=shared)[::2], cfg)
            h, a = remat(h, group_p)
        else:
            h, group_caches, a = _apply_group(group_p, h, positions, cfg, shared=shared)
            if return_cache:
                per_group.append(group_caches)
        aux = _add_aux(aux, a)
    if last_only:
        h = h[:, :, -1:]
    logits = _readout(params, h, cfg)
    if not return_cache:
        return logits, aux, None
    caches["blocks"] = stack(per_group, dim=1)
    return logits, aux, caches


def forward(params, batch, cfg: ModelConfig, *, return_cache: bool = False,
            last_only: bool = False):
    """Full-sequence forward of m models on tokens (m, B, S) ->
    logits f32 (m, B, S, V) [, prefill caches]; the VLM's inputs also
    hold patch_embeds (m, B, P, P_in) and its logits cover P + S positions.

    ``last_only`` reads out the last position alone, (m, B, 1, V): what
    a prefill step returns, without the (m, B, S, V) logits. The caches
    hold every slot's own state, each leaf stacked over the groups:
    ``{"blocks": {"l{i}": {"k", "v"} (m, G, B, S, Hkv, Dh) of an
    attention slot, {"h" (m, G, B, H, P, N) f32, "conv" (m, G, B, W − 1,
    C)} of a mamba slot}}``, and ``"first_block": {"k", "v"}`` (m, B, S,
    Hkv, Dh) where there is one. The MoE layers' aux loss is ``loss_fn``'s.
    """
    logits, _, caches = _forward(params, batch, cfg, return_cache=return_cache,
                                 last_only=last_only)
    return (logits, caches) if return_cache else logits


def loss_fn(params, batch, cfg: ModelConfig, *, aux_weight=0.01):
    """(m,) f32: each model's mean next-token NLL over its (B, S) tokens
    ``batch["tokens"]`` against ``batch["labels"]`` (m, B, S), plus
    ``aux_weight`` times the sum of its MoE layers' aux losses (0 for a
    family without MoE layers), as in the reference. The VLM's labels
    cover its token positions, the last S of its logits."""
    logits, aux, _ = _forward(params, batch, cfg, return_cache=False, last_only=False)
    labels = batch["labels"].long()  # the reference's int32 labels too
    if cfg.family == "vlm":
        logits = logits[:, :, -labels.shape[-1]:]
    m = labels.shape[0]
    nll = F.cross_entropy(logits.flatten(0, -2), labels.flatten(), reduction="none")
    loss = nll.view(m, -1).mean(dim=1)
    return loss if aux is None else loss + aux_weight * aux


# --------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, clients: int, batch: int, max_len: int, device=None):
    """Empty caches of m = ``clients`` models, leaves (m, G, ...): an
    attention slot's k and v (m, G, B, L, Hkv, Dh) in ``cfg.act_dtype``
    and pos (m, G, L) int32, L being max_len or min(window, max_len) for a
    window layer; a mamba slot's h (m, G, B, H, P, N) f32 and conv (m, G,
    B, W − 1, C) in ``cfg.act_dtype``; the hybrid's shared slot a cache
    of its own in every group; ``first_block``'s (m, B, max_len, Hkv, Dh)
    without the group axis. On ``device``, CUDA when None."""
    _check(cfg)
    device = resolve_device(device)
    acfg = attn_config(cfg)
    mg = clients * cfg.num_groups
    out = {}
    for i, slot in enumerate(_group_slots(cfg)):
        if slot == "mamba":
            one = ssm.init_cache(mg, batch, ssm_config(cfg), cfg.act_tdtype, device)
        else:
            window = _window(cfg, slot)
            length = min(window, max_len) if window else max_len
            one = attention.init_cache(mg, batch, length, acfg, cfg.act_tdtype, device)
        out[f"l{i}"] = tree_map(lambda x: x.unflatten(0, (clients, cfg.num_groups)), one)
    caches = {"blocks": out}
    if cfg.first_dense:
        caches["first_block"] = attention.init_cache(clients, batch, max_len, acfg,
                                                     cfg.act_tdtype, device)
    return caches


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig):
    """One-token decode of m models. tokens (m, B, 1); ``pos`` a host int.

    Writes the caches in place and returns (logits (m, B, 1, V) f32,
    caches).
    """
    _check(cfg)
    h = _embed_tokens(params, tokens, cfg)
    if cfg.first_dense:
        h, _, _ = _apply_attn_layer(params["first_block"], h, None, cfg, "attn_global",
                                    cache=caches["first_block"], pos=pos)
    shared = params.get("shared_attn")
    for group_p, group_c in zip(_groups(params["blocks"], cfg), _groups(caches["blocks"], cfg)):
        h, _, _ = _apply_group(group_p, h, None, cfg, caches=group_c, pos=pos, shared=shared)
    return _readout(params, h, cfg), caches
