"""What a rank holds under expert parallelism (``repro.launch.sharding``'s
MoE rules).

The reference's module gives every parameter, cache and batch leaf an XLA
``PartitionSpec`` and lets the compiler place the arrays
(``param_specs``, ``cache_specs``, ``batch_specs``, ``named``). Those
helpers place XLA arrays and have no torch meaning: a rank of the port
holds plain tensors, and its batch slice is the caller's to take. They are
not ported. What decides the tensors a rank holds is the MoE rows of its
rules (``src/repro/launch/sharding.py:60-65``): each expert leaf,
w_gate and w_up (..., E, D, F) and w_down (..., E, F, D), is split into
blocks, E over the config's ``expert_axis`` and F over "model"; every
other leaf is whole on every rank. A rank at (data d, model j) of an
(R, M) mesh holds experts [d·E/R, (d+1)·E/R) and d_ff columns
[j·F/M, (j+1)·F/M). A pod axis holds replicas of the same blocks.

  * :func:`rank_block` cuts a whole tree to this rank's blocks;
  * :func:`gather_blocks` all-gathers the blocks back into the whole tree
    (for a checkpoint);
  * :func:`rank_params` builds a rank's params directly: each expert from
    a seed of its own (:func:`repro_torch.models.moe.init`), so no rank
    materializes the whole expert stack and a one-rank run (``mesh=None``)
    builds the same whole model as ``transformer.init``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.federated import mesh as mesh_lib
from repro_torch.models import moe, registry, transformer

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def is_expert_leaf(path) -> bool:
    """Whether the leaf at ``path`` (its dict keys) is an MoE expert stack."""
    return len(path) >= 2 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts (None and other leaves
    passed to ``fn`` too)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _f_axis(name: str) -> int:
    return -1 if name in ("w_gate", "w_up") else -2  # w_down is (..., E, F, D)


def expert_block(cfg: ModelConfig, mesh) -> moe.ExpertBlock:
    """This rank's experts and d_ff columns of every MoE layer; the whole
    stack when ``mesh`` is None or the config names no expert axis (the
    sort dispatch runs on every rank then)."""
    e, f = cfg.moe_num_experts, cfg.moe_d_ff or cfg.d_ff
    if mesh is None or cfg.expert_axis is None:
        return moe.ExpertBlock(0, e, 0, f)
    r, mm = mesh.shape[cfg.expert_axis], mesh.shape["model"]
    if e % r or f % mm:
        raise ValueError(f"{cfg.name}: {e} experts over {r} ranks or d_ff {f} over {mm} "
                         "do not divide")
    d, j = mesh.coords[cfg.expert_axis], mesh.coords["model"]
    return moe.ExpertBlock(d * (e // r), (d + 1) * (e // r), j * (f // mm), (j + 1) * (f // mm))


def rank_block(params, cfg: ModelConfig, mesh):
    """This rank's copy of ``params``: every expert leaf cut to its block
    (a copy, so the whole stack can go), every other leaf as it is."""
    blk = expert_block(cfg, mesh)

    def cut(path, x):
        if not is_expert_leaf(path):
            return x
        x = x.narrow(-3, blk.e_lo, blk.e_hi - blk.e_lo)
        return x.narrow(_f_axis(path[-1]), blk.f_lo, blk.f_hi - blk.f_lo).clone()

    return map_with_path(cut, params)


def _gather_axis(x, axis: int, view):
    """Every rank's ``x`` of the 1-D mesh ``view`` joined along ``axis`` in
    rank order."""
    if view.group is None:
        return x
    out = mesh_lib.all_gather_rows(x.movedim(axis, 0).contiguous(), view)
    return out.movedim(0, axis)


def gather_blocks(params, cfg: ModelConfig, mesh):
    """The whole tree from every rank's blocks: each expert leaf
    all-gathered over "model" (its d_ff columns), then over the expert
    axis (its experts), in rank order; on every rank."""
    def join(path, x):
        if not is_expert_leaf(path):
            return x
        x = _gather_axis(x, x.dim() + _f_axis(path[-1]), mesh.axis("model"))
        return _gather_axis(x, x.dim() - 3, mesh.axis(cfg.expert_axis))

    return map_with_path(join, params)


def rank_params(cfg: ModelConfig, seed: int, mesh=None, device=None):
    """One model's params from a generator seeded ``seed`` as this rank of
    ``mesh`` holds them (the whole model when None): its module's ``init``,
    which builds only this rank's experts and d_ff columns
    (:func:`expert_block`; each expert from a seed of its own)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if cfg.family != "moe":
        return registry.module(cfg).init(gen, cfg, device)
    return transformer.init(gen, cfg, device, expert_block=expert_block(cfg, mesh))
