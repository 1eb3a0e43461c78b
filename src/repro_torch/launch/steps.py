"""Step builders (``repro.launch.steps``: ``build_train_step``,
``build_prefill_step``, ``build_serve_step``).

The paper's technique lives inside ``train_step``: one local SGD step per
client, then the PS aggregation over the client axis:

  * ``agg="fedavg"``       — Eq. 1: the mean over clients;
  * ``agg="user_centric"`` — Eq. 8: θ_i ← Σ_j W[i,j] θ_j;
  * ``agg="clustered"``    — §IV-B: k centroid mixes, then a row gather;
  * ``agg="local"``        — no mixing.

Every leaf carries a leading client axis (m, ...), inputs are (m, B, ...),
and the reference's ``vmap`` over clients is that axis written out
(batched products over clients, clients folded into the attention
kernel's batch). Each mix is the engine's (:mod:`repro_torch.core.aggregation`):
leaf by leaf on the mix kernel over the leaf's (m, numel) f32 view, cast
back to the leaf's dtype, with W and the centroid rules rounded to the
params' dtype first, as the reference rounds them. Momentum buffers stay
client-local and are never mixed. ``federated=False`` serves one model
with the reference's shapes. The ``abstract_*``/``input_specs`` helpers
read XLA lowerings and come with the analysis tooling (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregation
from repro_torch.core.pytree import leaves, tree_map, unflatten
from repro_torch.models import registry
from repro_torch.models.registry import one, unone
from repro_torch.optim import sgd_update

AGGS = ("user_centric", "clustered", "fedavg", "local")


def _tracked(params):
    """Detached leaves that autograd will differentiate."""
    return tree_map(lambda x: x.detach().requires_grad_(True), params)


# ------------------------------------------------------------------ train
def build_train_step(cfg: ModelConfig, *, n_clients: int, agg: str, num_streams: int | None = None,
                     lr: float = 0.1, momentum: float = 0.9, mix_gather_shardings=None):
    """Returns train_step with signature depending on the regime.

    federated:  (params, opt, mix, batch) -> (params, opt, metrics)
                where mix = W (m, m) | (centroid_w (k, m), labels (m,)) | ()
    fedsgd:     (params, opt, batch) -> (params, opt, metrics)

    params and opt (:func:`repro_torch.optim.sgd_init`) are trees of
    tensors with a leading client axis (one model's in fedsgd); they are
    not written, the step returns new ones. ``metrics["loss"]`` is the
    mean of the clients' losses before the step, a 0-d tensor. One
    backward pass over the sum of the clients' losses gives each client
    its own gradient.
    """
    if mix_gather_shardings is not None:
        raise TypeError("build_train_step: mix_gather_shardings places the mix on a 2-D "
                        "(data, model) device mesh, which waits for ROADMAP queue A's item A5, "
                        "the 2-D mesh for expert parallelism")
    if agg not in AGGS:
        raise ValueError(agg)

    if cfg.regime == "fedsgd_sharded":
        model = registry.build(cfg)

        def fedsgd_step(params, opt, batch):
            p = _tracked(params)
            loss = model.loss(p, batch)
            grads = unflatten(p, torch.autograd.grad(loss, leaves(p), materialize_grads=True))
            with torch.no_grad():
                params, opt = sgd_update(grads, opt, tree_map(torch.detach, p), lr=lr,
                                         momentum=momentum)
            return params, opt, {"loss": loss.detach()}
        return fedsgd_step

    def rounded(w):  # the reference's w.astype(x.dtype), in f32
        return w.to(cfg.param_tdtype).to(torch.float32)

    loss_fn = registry.module(cfg).loss_fn

    def train_step(params, opt, mix, batch):
        p = _tracked(params)
        loss = loss_fn(p, batch, cfg)  # (m,) per-client losses
        grads = unflatten(p, torch.autograd.grad(loss.sum(), leaves(p), materialize_grads=True))
        with torch.no_grad():
            params, opt = sgd_update(grads, opt, tree_map(torch.detach, p), lr=lr,
                                     momentum=momentum)
            del grads, p
            if agg == "user_centric":
                params = aggregation.user_centric(params, rounded(mix))
            elif agg == "clustered":
                params = aggregation.mix_centroids(params, rounded(mix[0]), mix[1])
            elif agg == "fedavg":  # the mean, in f32
                params = aggregation.fedavg(params, torch.ones(n_clients, device=loss.device))
        return params, opt, {"loss": loss.detach().mean()}

    return train_step


def build_prefill_step(cfg: ModelConfig, *, federated: bool):
    """prefill_step(params, batch) -> (logits of the last position, caches).

    Federated: tokens (m, B, S), with the family's other inputs (whisper's
    frames, the VLM's patch_embeds), -> logits (m, B, 1, V) f32 and the
    family's caches (k, v (m, G, B, S, Hkv, Dh) of a transformer). Only the
    last position is read out (the reference computes every position's
    logits and keeps the last).
    """
    forward = registry.module(cfg).forward

    def prefill_clients(params, batch):
        return forward(params, batch, cfg, return_cache=True, last_only=True)

    if federated:
        return prefill_clients

    def prefill_one(params, batch):
        logits, caches = prefill_clients(one(params), one(batch))
        return logits[0], unone(caches)

    return prefill_one


def build_serve_step(cfg: ModelConfig, *, federated: bool):
    """serve_step(params, caches, tokens, pos) -> (logits, caches): one-token
    decode with the KV cache, written in place; ``pos`` a host int.

    Federated: tokens (m, B, 1) -> logits (m, B, 1, V) f32.
    """
    decode_step = registry.module(cfg).decode_step

    def serve_clients(params, caches, tokens, pos):
        return decode_step(params, caches, tokens, pos, cfg)

    return serve_clients if federated else registry.build(cfg).decode_step
