"""Federated LM training driver (``repro.launch.train``).

Trains a transformer-zoo architecture with m federated clients on
heterogeneous synthetic LM tasks (per-group vocab-permutation chains,
:mod:`repro_torch.data.lm_synthetic`): first the collaboration round
(Eq. 9/10) on real LM gradients, K = 4 partitions a client, then the
chosen aggregation every round (:func:`repro_torch.launch.steps.build_train_step`).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 30

``--smoke`` (the default) trains ``cfg.reduced(vocab_size=64, remat=False)``;
``--no-smoke`` trains the configuration as it is. Runs on CUDA unless
``--device cpu``. ``main`` returns the final round's loss.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import similarity
from repro_torch.core.pytree import leaves, stacked_ravel, tree_count_params, tree_map, unflatten
from repro_torch.data import lm_synthetic
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import steps as steplib
from repro_torch.models import registry
from repro_torch.optim import sgd_init

PARTS = 4  # K, the minibatch partition of the collaboration round


def client_params(cfg, m: int, gen: torch.Generator, device):
    """One init from ``gen`` (the family's module: whisper's for the audio
    family), copied to m clients: leaves (m, ...)."""
    one = registry.module(cfg).init(gen, cfg, device)
    return tree_map(lambda x: x[None].repeat((m,) + (1,) * x.dim()), one)


def partition_grads(cfg, params, gen, chains, *, batch: int, seq: int, parts: int = PARTS):
    """The (m, K, d_aligned) gradients of the collaboration round in the
    params' dtype: client i's gradient on K fresh batches of its chain,
    each raveled (the reference's leaf order) straight into its rows of
    one zero-tailed buffer, so no (m, d) concatenation and no unaligned
    copy is made."""
    ls = leaves(params)
    m = ls[0].shape[0]
    d = tree_count_params(params) // m
    loss_fn = registry.module(cfg).loss_fn
    g = torch.zeros((m, parts, ops.aligned_dim(d)), dtype=ls[0].dtype, device=ls[0].device)
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    for k in range(parts):
        b = lm_synthetic.federated_lm_batch(gen, chains, m, batch, seq)
        loss = loss_fn(p, b, cfg)
        grads = torch.autograd.grad(loss.sum(), leaves(p), materialize_grads=True)
        stacked_ravel(unflatten(p, grads), out=g[:, k])
        del grads, loss
    return g


def collaboration(cfg, params, gen, chains, *, batch: int, seq: int, parts: int = PARTS):
    """The collaboration round (Eq. 9/10) on real LM gradients: full
    gradients (m, d_aligned) f32, σ² (m,), Δ (one Gram launch on the
    aligned rows) and W, with every client's n its batch·seq tokens."""
    g = partition_grads(cfg, params, gen, chains, batch=batch, seq=seq, parts=parts)
    m = g.shape[0]
    n = torch.full((m,), float(batch * seq), dtype=torch.float32, device=g.device)
    return similarity.collaboration_round(g, n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="train the reduced config (--no-smoke: the config as it is)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--agg", default="user_centric", choices=["user_centric", "fedavg", "local"])
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced(vocab_size=64, remat=False)
    m = args.clients
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = client_params(cfg, m, gen, dev)
    opt = sgd_init(params, momentum=cfg.momentum)
    chains = lm_synthetic.make_group_chains(gen, args.groups, cfg.vocab_size)

    # ---- collaboration round (Eq. 9/10) on real LM gradients
    w = collaboration(cfg, params, gen, chains, batch=args.batch, seq=args.seq)["W"]
    print("collaboration matrix W:")
    print(np.array_str(w.cpu().numpy(), precision=3, suppress_small=True))

    train_step = steplib.build_train_step(cfg, n_clients=m, agg=args.agg, lr=args.lr,
                                          momentum=cfg.momentum)
    mix = w if args.agg == "user_centric" else ()

    t0 = time.time()
    for r in range(1, args.rounds + 1):
        batch = lm_synthetic.federated_lm_batch(gen, chains, m, args.batch, args.seq)
        params, opt, metrics = train_step(params, opt, mix, batch)
        if r % max(args.rounds // 10, 1) == 0 or r == 1:
            print(f"round {r:4d} loss={float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.1f}s)")
    print(f"done: final loss {float(metrics['loss']):.4f} in {time.time() - t0:.1f}s")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
