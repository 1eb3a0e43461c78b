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
leaf by leaf on the mix kernel over the leaf's (m, numel) view in its
storage dtype (bf16 or f32; f32 sums, the result in the leaf's dtype),
with W and the centroid rules rounded to the params' dtype first, as the
reference rounds them. Momentum buffers stay
client-local and are never mixed. ``federated=False`` serves one model
with the reference's shapes. ``abstract_params``, ``abstract_opt``,
``input_specs`` and ``abstract_cache`` build the steps' arguments as
tensors on the ``meta`` device, with the reference's shapes and dtypes
and nothing drawn or allocated, for the dry run
(:mod:`repro_torch.launch.dryrun`).

On a mesh (SPMD ranks over ``torch.distributed``):

  * ``mix_gather_shardings`` (the reference's gather placement) takes the
    mesh whose ranks hold the clients: a
    :class:`repro_torch.federated.mesh.ClientMesh`, or a
    :class:`repro_torch.launch.mesh.RankMesh` (its client axes). A rank
    passes its m/s clients' rows of params, opt and batch, and the whole W
    (or the centroid rules and labels); each leaf's rows are all-gathered
    in the leaf's storage dtype and mixed on the mix kernel into the
    rank's rows (``user_centric``: W[lo:hi]; ``clustered``: the centroid
    mixes, then the rank's labels; ``fedavg``: the f32 mean of all m).
    The loss is the mean over all m clients.
  * the ``fedsgd_sharded`` step under expert parallelism
    (``moe.set_ep_mesh``, a config with an expert axis) takes the rank's
    batch slice and params (:mod:`repro_torch.launch.sharding`). The expert
    leaves' gradients stay local (divided by the expert axis's size: the
    exchange already summed every rank's tokens into them; averaged over
    the pod axis, whose ranks hold replicas); every other leaf's gradient
    is averaged over the client axes, not over "model", whose ranks hold
    the same tokens. The loss metric is the client axes' mean.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregation
from repro_torch.core.pytree import leaves, tree_map, unflatten
from repro_torch.federated import mesh as mesh_lib
from repro_torch.launch import sharding
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import moe, registry
from repro_torch.models.registry import one, unone
from repro_torch.optim import sgd_init, sgd_update

AGGS = ("user_centric", "clustered", "fedavg", "local")
META = torch.device("meta")


def _tracked(params):
    """Detached leaves that autograd will differentiate."""
    return tree_map(lambda x: x.detach().requires_grad_(True), params)


def _gather_view(placement):
    """The client mesh of ``mix_gather_shardings``: a ClientMesh, or a
    RankMesh's client axes; None for None; ``TypeError`` otherwise."""
    if placement is None or isinstance(placement, mesh_lib.ClientMesh):
        return placement
    if isinstance(placement, RankMesh):
        return placement.clients()
    raise TypeError("build_train_step: mix_gather_shardings takes the mesh that holds the "
                    "clients (a repro_torch.federated.mesh.ClientMesh or a "
                    f"repro_torch.launch.mesh.RankMesh), got {type(placement).__name__}")


def _ep_grads(grads, cfg: ModelConfig, mesh):
    """The fedsgd gradients of a rank under expert parallelism, as the
    whole-batch step's: expert leaves divided by the expert axis's size
    (and averaged over the pods), every other leaf averaged over the client
    axes."""
    r = mesh.shape[cfg.expert_axis]
    pods = mesh.axis("pod") if "pod" in mesh.axis_names else None
    clients = mesh.clients()

    def fix(path, g):
        if sharding.is_expert_leaf(path):
            g = g / r
            return g if pods is None else mesh_lib.axis_mean(g, pods)
        return mesh_lib.axis_mean(g, clients)

    return sharding.map_with_path(fix, grads)


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
    gather = _gather_view(mix_gather_shardings)
    if agg not in AGGS:
        raise ValueError(agg)

    if cfg.regime == "fedsgd_sharded":
        model = registry.build(cfg)

        def fedsgd_step(params, opt, batch):
            p = _tracked(params)
            loss = model.loss(p, batch)
            grads = unflatten(p, torch.autograd.grad(loss, leaves(p), materialize_grads=True))
            loss = loss.detach()
            with torch.no_grad():
                mesh = moe.ep_mesh() if cfg.expert_axis else None
                if mesh is not None:
                    grads = _ep_grads(grads, cfg, mesh)
                    loss = mesh_lib.axis_mean(loss, mesh.clients())
                params, opt = sgd_update(grads, opt, tree_map(torch.detach, p), lr=lr,
                                         momentum=momentum)
            return params, opt, {"loss": loss}
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
            if gather is not None:
                params = gathered_mix(params, mix)
                return params, opt, {"loss": mesh_lib.all_gather_rows(loss.detach(),
                                                                      gather).mean()}
            if agg == "user_centric":
                params = aggregation.user_centric(params, rounded(mix))
            elif agg == "clustered":
                params = aggregation.mix_centroids(params, rounded(mix[0]), mix[1])
            elif agg == "fedavg":  # the mean, in f32
                params = aggregation.fedavg(params, torch.ones(n_clients, device=loss.device))
        return params, opt, {"loss": loss.detach().mean()}

    def gathered_mix(params, mix):
        """The rank's rows of the mix: each leaf's m rows all-gathered in
        its storage dtype (one leaf at a time), mixed into the rank's."""
        lo, hi = gather.block(n_clients)
        if any(x.shape[0] != hi - lo for x in leaves(params)):
            raise ValueError(f"build_train_step: a rank of the {gather.shards}-rank client mesh "
                             f"holds {hi - lo} of the {n_clients} clients' rows")
        if agg == "user_centric":
            w = rounded(mix)[lo:hi]
            return tree_map(lambda x: aggregation.user_centric(
                mesh_lib.all_gather_rows(x, gather), w), params)
        if agg == "clustered":
            rules, labels = rounded(mix[0]), mix[1][lo:hi]
            return tree_map(lambda x: aggregation.mix_centroids(
                mesh_lib.all_gather_rows(x, gather), rules, labels), params)
        if agg == "fedavg":
            n = torch.ones(n_clients, device=leaves(params)[0].device)
            return tree_map(lambda x: aggregation.fedavg(
                mesh_lib.all_gather_rows(x, gather), n)[:hi - lo], params)
        return params

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


# ------------------------------------------------------------------ specs
def _lead(tree, n_clients):
    """Every leaf of a meta tree with a leading (n_clients,) axis."""
    return tree_map(lambda x: torch.empty((n_clients,) + tuple(x.shape), dtype=x.dtype,
                                          device=META), tree)


def abstract_params(cfg: ModelConfig, *, n_clients: int | None = None):
    """The model's params as ``meta`` tensors (no draw, no allocation): one
    model's tree, or with a leading (n_clients,) axis on every leaf."""
    one = registry.module(cfg).init(None, cfg, META)
    return one if n_clients is None else _lead(one, n_clients)


def abstract_opt(abs_params, *, momentum: float):
    """The momentum buffers of :func:`repro_torch.optim.sgd_init` on meta
    (``()`` when momentum is 0)."""
    return sgd_init(abs_params, momentum=momentum)


def input_specs(cfg: ModelConfig, shape: InputShape, *, n_clients: int | None):
    """Meta stand-ins for every model input of this shape, the reference's
    shapes and dtypes: int32 tokens (and labels), the VLM's patch_embeds
    and whisper's frames in the activation dtype.

    n_clients=None -> no client axis (fedsgd / single-request serving);
    otherwise the leading (m, per_client_batch, ...) layout."""
    if n_clients is not None:
        if shape.global_batch % n_clients:
            raise ValueError(f"{shape}: global batch {shape.global_batch} is not a multiple "
                             f"of {n_clients} clients")
        lead = (n_clients, shape.global_batch // n_clients)
    else:
        lead = (shape.global_batch,)

    def sds(*dims, dtype=torch.int32):
        return torch.empty(lead + dims, dtype=dtype, device=META)

    act = cfg.act_tdtype
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds(shape.seq_len)}
        if shape.kind == "train":
            batch["labels"] = sds(shape.seq_len)
        if cfg.family == "vlm":
            batch["patch_embeds"] = sds(cfg.num_patches, cfg.patch_embed_dim, dtype=act)
        if cfg.family == "audio":
            batch["frames"] = sds(cfg.encoder_seq, cfg.d_model, dtype=act)
        return batch
    if shape.kind == "decode":
        return {"tokens": sds(1)}
    raise ValueError(shape.kind)


def abstract_cache(cfg: ModelConfig, shape: InputShape, *, n_clients: int | None):
    """The serve step's KV/SSM caches (and whisper's cross K/V) on meta for
    a batch of ``shape.global_batch`` requests (per client with
    ``n_clients``) of ``shape.seq_len`` positions."""
    b = shape.global_batch if n_clients is None else shape.global_batch // n_clients
    caches = registry.module(cfg).init_cache(cfg, 1 if n_clients is None else n_clients, b,
                                             shape.seq_len, META)
    return unone(caches) if n_clients is None else caches
