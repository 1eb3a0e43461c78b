"""Build the functional model bundle for a ModelConfig (``repro.models.registry``).

The bundle serves one model: its functions take the reference's
single-model params (no client axis) and add and drop the client axis of
the family's module around each call: :mod:`repro_torch.models.whisper`
for the audio family, :mod:`repro_torch.models.transformer` for the rest
(:func:`module`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer, whisper


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]  # (generator, device=None: CUDA) -> params
    forward: Callable[..., Any]  # (params, batch) -> logits (B, S, V)
    loss: Callable[..., Any]  # (params, batch) -> scalar mean NLL + 0.01 · aux
    init_cache: Callable[..., Any]  # (batch, max_len, device=None: CUDA) -> caches
    decode_step: Callable[..., Any]  # (params, caches, tokens, pos) -> (logits, caches)


def one(tree):
    """A single model's tree as m = 1 clients (views, no copy)."""
    return transformer.tree_map(lambda x: x[None], tree)


def unone(tree):
    return transformer.tree_map(lambda x: x[0], tree)


def module(cfg: ModelConfig):
    """The module of the configuration's family: whisper for audio, else
    transformer. Both take m models, leaves (m, ...)."""
    return whisper if cfg.family == "audio" else transformer


def build(cfg: ModelConfig) -> Model:
    mod = module(cfg)

    def decode_step(params, caches, tokens, pos):
        logits, new = mod.decode_step(one(params), one(caches), tokens[None], pos, cfg)
        return logits[0], unone(new)

    return Model(
        cfg=cfg,
        init=lambda gen, device=None: mod.init(gen, cfg, device),
        forward=lambda p, b: mod.forward(one(p), one(b), cfg)[0],
        loss=lambda p, b: mod.loss_fn(one(p), one(b), cfg)[0],
        init_cache=lambda batch, max_len, device=None: unone(
            mod.init_cache(cfg, 1, batch, max_len, device)),
        decode_step=decode_step,
    )
