"""Serving step builders (``repro.launch.steps``: ``build_prefill_step``,
``build_serve_step``).

``federated=True`` serves m personalized models at once: every params
leaf carries a leading client axis (m, ...), inputs are (m, B, ...), and
the reference's ``vmap`` over clients is that axis written out (batched
products over clients, clients folded into the attention kernel's batch).
``federated=False`` serves one model with the reference's shapes.

``build_train_step`` and the ``abstract_*``/``input_specs`` helpers come
with the transformer training slice (ROADMAP queue A).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry, transformer
from repro_torch.models.registry import one, unone


def build_prefill_step(cfg: ModelConfig, *, federated: bool):
    """prefill_step(params, batch) -> (logits of the last position, caches).

    Federated: tokens (m, B, S) -> logits (m, B, 1, V) f32 and caches with
    k, v (m, G, B, S, Hkv, Dh). Only the last position is read out (the
    reference computes every position's logits and keeps the last).
    """
    def prefill_clients(params, batch):
        return transformer.forward(params, batch, cfg, return_cache=True, last_only=True)

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
    def serve_clients(params, caches, tokens, pos):
        return transformer.decode_step(params, caches, tokens, pos, cfg)

    return serve_clients if federated else registry.build(cfg).decode_step
