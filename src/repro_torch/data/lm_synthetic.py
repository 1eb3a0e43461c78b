"""Synthetic heterogeneous LM data for the training driver
(``repro.data.lm_synthetic``).

Each heterogeneity group g owns a hidden permutation π_g over the vocab;
sequences follow x_{t+1} = π_g(x_t) with probability 1 − ε, else uniform
noise. A model reaches a low loss only by learning its group's chain, the
conflicting-task structure of the paper's concept-shift scenario, so the
user-centric weights have real signal to find.

Draws come from a ``torch.Generator`` and land on its device; they match
the reference in law only (its draws are ``jax.random``'s).
"""
from __future__ import annotations

import torch


def make_group_chains(gen: torch.Generator, groups: int, vocab: int):
    """(groups, vocab) int64: one permutation of the vocab a group."""
    return torch.stack([torch.randperm(vocab, generator=gen, device=gen.device)
                        for _ in range(groups)])


def _chain_walks(gen, chains, batch: int, seq: int, noise: float):
    """(c, batch, seq) walks, walk set i under permutation ``chains[i]``."""
    c, vocab = chains.shape
    dev = gen.device
    x = torch.randint(0, vocab, (c, batch), generator=gen, device=dev)
    rand = torch.randint(0, vocab, (seq, c, batch), generator=gen, device=dev)
    use_noise = torch.rand((seq, c, batch), generator=gen, device=dev) < noise
    out = torch.empty((seq, c, batch), dtype=torch.int64, device=dev)
    for t in range(seq):
        x = torch.where(use_noise[t], rand[t], torch.gather(chains, 1, x))
        out[t] = x
    return out.permute(1, 2, 0)


def sample_sequences(gen: torch.Generator, chain, batch: int, seq: int, *, noise: float = 0.05):
    """(batch, seq) Markov-chain sequences under one permutation (vocab,):
    a uniform start x_0 (not part of the output), then seq steps."""
    return _chain_walks(gen, chain[None].to(gen.device), batch, seq, noise)[0]


def federated_lm_batch(gen: torch.Generator, chains, m: int, batch: int, seq: int, *,
                       noise: float = 0.05):
    """{"tokens", "labels"}, each (m, batch, seq) int64: sequences of seq + 1
    steps, client i under chain i % groups, labels the tokens shifted by
    one."""
    groups = chains.shape[0]
    per_client = chains.to(gen.device)[torch.arange(m, device=gen.device) % groups]
    seqs = _chain_walks(gen, per_client, batch, seq + 1, noise)
    return {"tokens": seqs[:, :, :-1], "labels": seqs[:, :, 1:]}
