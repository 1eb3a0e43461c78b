"""FedFomo (Zhang et al., 2020): first-order mixing on the clients.

Every round each client downloads the other clients' models (the m×
downlink the paper criticizes, "client_mixing" in the comm model), scores
them on a held-out validation split of its own data and mixes:

  w_{i,j} = max(0, (L_i(θ_i) − L_i(θ_j)) / ||θ_j − θ_i||),  normalized,
  θ_i ← θ_i + Σ_j ŵ_{i,j} (θ_j − θ_i).

The first ``val_frac`` of each client's samples is its validation split;
local SGD runs on the rest, so ``round(..., perms=)`` takes batch orders
of the (n − n_val)-sample train split. The distances come from the Gram
kernel over the trained slab rows (Δ = ||θ_i||² + ||θ_j||² − 2⟨θ_i, θ_j⟩,
as the reference forms it) and the mix from ``mix_aggregate`` (k = c).
The (c, c) loss matrix L[i, j] = L_i(θ_j) is built ``LOSS_CHUNK`` models a
pass: each model runs over all clients' validation rows at once, and each
client's mean gives the column. The cohort round mixes over the real
slots only (pad columns weigh 0) and writes the real slots back.

Wire: a ``delta`` upload, quantized before the loss matrix, so the peers
score and mix the models the wire carried; the ``peer_models`` downlink
relays those quantized uploads (priced compressed, no second stage). The
upload stage (faults, robust) rewrites the uploads before they are
scored; its final mask zeroes the demoted columns (no peer downloads a
guarded model) and a demoted slot keeps its row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import similarity
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import client as fedclient
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib
from repro_torch.kernels import ops

# models scored a pass of the loss matrix: at m = 100 and 200 validation
# rows a client, a pass of 10 holds their conv1 patches, 11.5 GB, at once
LOSS_CHUNK = 10


@torch.no_grad()
def loss_matrix(apply_stacked, layout, flat, x_val, y_val, chunk):
    """L[i, j]: client i's mean validation loss under model j, (c, c).

    flat (c, dim_aligned) models; x_val (c, n_val, ...), y_val (c, n_val)."""
    c, n_val = y_val.shape
    xv = x_val.reshape((1, c * n_val) + tuple(x_val.shape[2:]))
    yv = y_val.reshape(-1)
    out = torch.empty((c, c), dtype=torch.float32, device=flat.device)
    for sl in fedclient.chunks(c, chunk):
        j = sl.stop - sl.start
        logits = apply_stacked(layout.unravel(flat[sl]), xv.expand((j,) + tuple(xv.shape[1:])))
        ce = F.cross_entropy(logits.reshape(j * c * n_val, -1), yv.repeat(j),
                             reduction="none")
        out[:, sl] = ce.view(j, c, n_val).mean(dim=2).T
    return out


def fomo_weights(lmat, flat, col_mask=None):
    """The normalized first-order weights ŵ (c, c); ``col_mask`` (c,) 0/1
    zeroes the pad columns, so no real client mixes in a pad slot's copy."""
    c = lmat.shape[0]
    dist = torch.sqrt(similarity.pairwise_delta(flat) + 1e-12)
    base = torch.diagonal(lmat)  # each client's own trained model
    raw = torch.clamp_min(base[:, None] - lmat, 0.0) / dist
    raw = raw * (1.0 - torch.eye(c, device=lmat.device))  # not itself
    if col_mask is not None:
        raw = raw * col_mask[None, :]
    norm = torch.sum(raw, dim=1, keepdim=True)
    return torch.where(norm > 0, raw / torch.clamp_min(norm, 1e-12), torch.zeros_like(raw))


def fomo_mix(flat, w):
    """θ_i + Σ_j ŵ_ij (θ_j − θ_i), with Σ_j ŵ_ij θ_j in one kernel launch."""
    return flat + ops.mix_aggregate(w, flat) - torch.sum(w, dim=1, keepdim=True) * flat


@register("fedfomo")
def make_fedfomo(apply_stacked, params0, cfg: FedConfig = FedConfig(), *,
                 val_frac: float = 0.2, device=None):
    topology_lib.unsupported(
        cfg.topology, "fedfomo",
        "client-side first-order mixing downloads every cohort peer's model per "
        "receiver (the m× downlink the paper prices) — there is no PS aggregate for an "
        "edge tier to ship")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "fedfomo", layout.dim,
        downlink=(transport_lib.Stream("peer_models", layout.dim, coding="relay"),))
    up, _ = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def split(x, y):
        """(train x, train y, validation x, validation y)."""
        n_val = max(int(y.shape[1] * val_frac), 1)
        return x[:, n_val:], y[:, n_val:], x[:, :n_val], y[:, :n_val]

    def mixed(post, x_val, y_val, col_mask=None):
        lmat = loss_matrix(apply_stacked, layout, post, x_val, y_val, LOSS_CHUNK)
        return fomo_mix(post, fomo_weights(lmat, post, col_mask))

    def init(gen, data):
        m = data.num_clients
        return {"params": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        x_tr, y_tr, x_val, y_val = split(data.x, data.y)
        post = local(state["params"], x_tr, y_tr, gen=gen, perms=perms)
        return {"params": mixed(post, x_val, y_val)}, {"streams": data.num_clients}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        x_tr, y_tr, x_val, y_val = split(co.x, co.y)
        pc = co.rows["params"]
        post = local(pc, x_tr, y_tr, perms=co.keys(perms, n=y_tr.shape[1]))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        fmask, final = co.mask, None
        if ustage is not None:
            post, _, fmask = common.upload(ustage, co, pc, post)
            final = fmask
        new = common.kept(final, mixed(post, x_val, y_val, fmask.float()), pc)
        return {"params": co.scatter(state["params"], new), **out}, {"streams": co.real}

    return Strategy("fedfomo", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="client_mixing", injects_faults=cfg.faults is not None,
                    wire_schema=schema)
