"""Personalized serving driver (``repro.launch.serve``): every federated
client serves its own personalized model. A prompt batch goes through
teacher-forced decode steps, then N tokens are decoded greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --no-smoke \\
      --clients 2 --batch 2 --prompt-len 128 --decode-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --device cpu

``--arch`` takes every configuration: the dense, MoE (mixtral-8x7b,
kimi-k2-1t-a32b), SSM (mamba2-1.3b), hybrid (zamba2-2.7b), VLM
(internvl2-1b) and audio (whisper-large-v3) families. As in the
reference, the prompt is tokens alone: the VLM's decode steps take no
patches, and whisper's caches come from ``init_cache`` without an
encoder output, so its cross K/V is zero.

``--smoke`` (the default) serves ``cfg.reduced(vocab_size=128)``;
``--no-smoke`` serves the configuration at full width and depth. Runs on
CUDA unless ``--device cpu``.

:func:`serve` also runs on a rank mesh (``mesh=``, a
:class:`repro_torch.launch.mesh.RankMesh`; every rank calls it): each
rank serves its slice of the requests (split over the client axes) on
one shared model, and a config with an expert axis shards its experts
over the mesh (``moe.set_ep_mesh`` for the call), each rank building only
its block (:func:`repro_torch.launch.sharding.rank_params`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import sharding
from repro_torch.launch import steps as steplib
from repro_torch.launch.mesh import num_clients
from repro_torch.models import moe, registry

NOISE = 0.01  # scale of each client's perturbation of the shared init


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (m, B, decode_tokens) int64, the greedy tokens
    logits: torch.Tensor  # (m, B, 1, V) f32, the last decode step's
    prefill_s: float  # the teacher-forced prompt's decode steps
    decode_s: float  # the greedy decode steps


def personalize(shared, clients: int, gen: torch.Generator):
    """m personalized copies of one model: the shared init plus
    ``0.01 · N(0, 1)`` per client, rounded to each leaf's dtype and added
    in it, as the reference does. Leaves (m, ...). The noise is drawn slice
    by slice (per client and per group), so no f32 copy of a whole leaf
    exists at once. ``shared`` (a tree of dicts) is emptied as it goes:
    each leaf is dropped once its copies are made, so the shared model and
    the m copies never coexist whole (phi3-medium-14b's 29.3 GB init beside
    its two clients' 58.6 GB would not fit 80 GB)."""
    def leaf(x):
        out = x[None].repeat((clients,) + (1,) * x.dim())
        for part in out.flatten(0, 1) if x.dim() > 2 else out:
            noise = torch.randn(part.shape, generator=gen, device=x.device,
                                dtype=torch.float32)
            part += (NOISE * noise).to(x.dtype)
        return out

    def drain(tree):
        out = {}
        for k in list(tree):
            v = tree.pop(k)
            out[k] = drain(v) if isinstance(v, dict) else leaf(v)
            del v
        return out

    return drain(shared)


def personalized_params(cfg, clients: int, seed: int, device):
    """The shared init from ``seed``, personalized for ``clients`` clients
    with noise from ``seed + 1``; both drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shared = registry.module(cfg).init(gen, cfg, device)
    gen.manual_seed(seed + 1)
    return personalize(shared, clients, gen)


def serve(cfg, *, clients, batch, prompt_len, decode_tokens, seed, device=None,
          mesh=None) -> ServeResult:
    """Serve ``clients`` personalized models, ``batch`` requests each: a
    random prompt of ``prompt_len`` tokens through teacher-forced decode
    steps, then ``decode_tokens`` greedy tokens. Times end in a device
    synchronize.

    With ``mesh`` (every rank of it calls ``serve``), one shared model
    (``clients`` must be 1; no personalization noise) serves the ``batch``
    requests split over the mesh's client axes: this rank's slice of the
    prompt, drawn whole from ``seed + 2`` on every rank; the model comes
    from ``sharding.rank_params(cfg, seed, mesh)``, its experts sharded
    over the mesh where the config names an expert axis. The result holds
    this rank's requests."""
    dev = resolve_device(device)
    lo, hi = 0, batch
    if mesh is None:
        params = personalized_params(cfg, clients, seed, dev)
    else:
        if clients != 1 or batch % num_clients(mesh):
            raise ValueError(f"serve on a mesh serves one shared model (clients=1, got "
                             f"{clients}) and splits the {batch} requests over its "
                             f"{num_clients(mesh)} client ranks")
        params = registry.one(sharding.rank_params(cfg, seed, mesh, dev))
        lo, hi = mesh.clients().block(batch)
    max_len = prompt_len + decode_tokens
    serve_step = steplib.build_serve_step(cfg, federated=True)
    caches = registry.module(cfg).init_cache(cfg, clients, hi - lo, max_len, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab_size, (clients, batch, prompt_len), generator=gen,
                           device=dev)[:, lo:hi]
    before = moe.ep_mesh()
    moe.set_ep_mesh(mesh if mesh is not None and cfg.expert_axis else before)
    try:
        return _serve_loop(serve_step, params, caches, prompt, prompt_len, max_len, dev)
    finally:
        moe.set_ep_mesh(before)


def _serve_loop(serve_step, params, caches, prompt, prompt_len, max_len, dev):
    """The prompt through teacher-forced decode steps, then greedy ones up
    to ``max_len``: the :class:`ServeResult`."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, caches = serve_step(params, caches, prompt[:, :, t:t + 1], t)
    sync()
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    cur = torch.argmax(logits, dim=-1)
    for t in range(prompt_len, max_len):
        logits, caches = serve_step(params, caches, cur, t)
        cur = torch.argmax(logits, dim=-1)
        out.append(cur)
    sync()
    decode_s = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=-1), logits, prefill_s, decode_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="serve the reduced config (--no-smoke: full width and depth)")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced(vocab_size=128, remat=False)
    res = serve(cfg, clients=args.clients, batch=args.batch, prompt_len=args.prompt_len,
                decode_tokens=args.decode_tokens, seed=args.seed, device=args.device)
    total = args.decode_tokens * args.batch * args.clients
    print(f"prefill {args.prompt_len} steps in {res.prefill_s:.2f}s; "
          f"decoded {total} tokens in {res.decode_s:.2f}s "
          f"({total / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample (client 0, request 0):", res.tokens[0, 0].tolist())
    return res.tokens


if __name__ == "__main__":
    main()
