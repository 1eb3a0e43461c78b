"""The paper's proposed method: User-Centric Federated Learning (dense path).

Algorithm 1 end-to-end, at full participation:
  1. special round — broadcast θ⁰; clients upload full gradients and σ_k²
     (Eq. 10) on a fixed minibatch partition of size ``var_batch_size``;
  2. the PS computes Δ (Gram kernel) and the mixing matrix W (Eq. 9);
  3. optionally K-means over the rows of W to m_t centroid rules (§IV-B,
     assignment kernel), picked by silhouette (Alg. 2) when
     ``num_streams="auto"``;
  4. every round: clients run ClientUpdate from their personalized model,
     and the PS applies the user-centric or clustered mix (mix kernel).

State: ``params`` is the (m, dim_aligned) f32 slab
(:class:`repro_torch.core.flat.LayoutTable`); ``W`` the (m, m) mixing
matrix; ``labels``/``streams`` the clustered variant's assignment and
stream count, with ``labels_host`` a host copy of ``labels``; ``collab``
the special round's statistics. The dense round mixes the whole slab in
ONE ``mix_aggregate`` launch (the rule is column-independent), where the
reference launches once per leaf.

Partial participation, ``round(state, data, gen, cohort)``: the masked
cohort round of :mod:`repro_torch.core.baselines.common` gathers the
cohort rows of the slab (one ``cohort_gather`` launch), trains them, turns
W into per-slot (c, c) rules (``masked_cohort_matrix``, or
``masked_clustered_rows`` for the clustered variant) and mixes and
scatters the real slots back in ONE ``masked_mix_scatter`` launch, in
place on the card; rows outside the cohort are not touched. The round's
``streams`` is counted on the host from the cohort: its real members
(full personalization) or the clusters they belong to. The cohort's
slots reach the card in one asynchronous copy from pinned memory, so
the host does not wait for the stream to drain before it queues the
round.

Wire (``FedConfig.transport``): one ``delta`` upload either way. Full
personalization also delta-codes its per-client ``personalized`` downlink
against each receiver's round-start row, with a server EF row a client
(``ef_dl``, (m, dim_aligned)): its cohort round then mixes the cohort
rows in one ``mix_aggregate`` launch, passes them through the downlink
stage and scatters the real slots, in place of the fused mix-scatter.
The clustered variant's ``centroids`` groupcast stays raw (a centroid is
no receiver's old model), and keeps the fused launch.

The baselines the paper compares against are in
:mod:`repro_torch.core.baselines`. ``ucfl_parallel`` and the engine knobs
come with later slices (ROADMAP queue A).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aggregation, clustering, flat, similarity
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import client as fedclient
from repro_torch.federated import transport as transport_lib
from repro_torch.kernels import ops


def compute_collaboration(apply_stacked, params0, data, *, var_batch_size=100,
                          chunk_size=None, layout=None):
    """Run the special pre-training round; returns the dict of §IV-A.

    Every (client, minibatch) pair of the fixed partition is one unit of
    the stacked model at θ⁰, so one backward pass gives all K minibatch
    gradients of a chunk of clients. ``chunk_size`` bounds that to
    (chunk·K, d) at a time; the chunk reduces at once to its (chunk, d)
    full gradients (their mean) and (chunk,) σ².
    """
    layout = layout or flat.LayoutTable.build(params0)
    theta0 = layout.ravel(params0)
    m, n = data.y.shape
    steps = n // var_batch_size
    fulls, sigs = [], []
    for sl in fedclient.chunks(m, chunk_size):
        c = sl.stop - sl.start
        # each client's fixed partition (loader.fixed_partition), stacked
        used = steps * var_batch_size
        xb = data.x[sl, :used].reshape(
            (c, steps, var_batch_size) + tuple(data.x.shape[2:]))
        yb = data.y[sl, :used].reshape(c, steps, var_batch_size)
        # the slab's pad columns never reach the loss: their gradient is 0
        g = fedclient.minibatch_gradients(apply_stacked, layout, theta0.expand(c, -1), xb, yb)
        full = torch.mean(g, dim=1)
        fulls.append(full)
        sigs.append(similarity.sigma_sq(g[..., : layout.dim], full[:, : layout.dim]))
    # Δ from the slab-wide rows: 16-byte aligned, so the Gram kernel reads
    # them where they lie, and the zero columns add nothing to any sum
    full = torch.cat(fulls).contiguous()
    sig = torch.cat(sigs)
    delta = similarity.pairwise_delta(full)
    w = similarity.mixing_weights(delta, sig, data.n.float())
    return {"full_grads": full[:, : layout.dim], "sigma_sq": sig, "delta": delta, "W": w}


@register("ucfl")
def make_ucfl(apply_stacked, params0, cfg: FedConfig = FedConfig(), *,
              num_streams=None, var_batch_size=100, device=None):
    """The proposed strategy.

    num_streams: None -> full personalization (m streams, Eq. 8);
                 int k -> clustered with k streams (§IV-B);
                 "auto" -> Alg. 2 silhouette selection.

    ``apply_stacked`` maps (U-stacked params, (U, B, H, W, C) inputs) to
    (U, B, K) logits, as :func:`repro_torch.models.lenet.apply_stacked`.
    ``params0`` moves to ``device`` (CUDA unless told otherwise). The
    kernel ops pick their route from the tensors' device alone: the CUDA
    kernels on the card, their plain versions on the CPU.
    """
    if not (num_streams is None or num_streams == "auto"
            or (isinstance(num_streams, int) and num_streams >= 1)):
        raise ValueError(f"num_streams must be None, 'auto' or an int >= 1, "
                         f"got {num_streams!r}")
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg)
    if num_streams is None:
        schema = transport_lib.single_delta_schema(
            "ucfl", layout.dim, downlink=(transport_lib.Stream("personalized", layout.dim),))
    else:
        schema = transport_lib.single_delta_schema(
            f"ucfl_k{num_streams}", layout.dim,
            downlink=(transport_lib.Stream("centroids", layout.dim, coding="raw"),))
    up, down = common.wire_stages(schema, cfg.transport)

    def init(gen, data, *, kmeans_init=None):
        """``kmeans_init`` (k, m) replaces the K-means++ seeds (parity
        tests pass the reference's)."""
        m = data.num_clients
        collab = compute_collaboration(
            apply_stacked, params0, data, var_batch_size=var_batch_size,
            chunk_size=cfg.chunk_size, layout=layout)
        w = collab["W"]
        labels = labels_host = None
        k = num_streams
        if k == "auto":
            k, _ = clustering.choose_num_streams(gen, w)
        if k is not None:
            labels = clustering.kmeans(gen, w, int(k), init_centroids=kmeans_init).labels
            # the cohort round counts its streams from this copy, not
            # with a device sync every round
            labels_host = labels.cpu().numpy()
        return {"params": layout.slab(params0, m), "W": w, "labels": labels,
                "labels_host": labels_host, "streams": k, "collab": collab,
                **common.wire_state(schema, cfg.transport, m, dev, dl_rows=m)}

    def dense(state, data, gen, perms):
        updated = local(state["params"], data.x, data.y, gen=gen, perms=perms)
        streams = state["streams"]
        if streams is None:
            mixed = aggregation.user_centric(updated, state["W"])
        else:
            mixed = aggregation.clustered(updated, state["W"], state["labels"], streams)
        return dict(state, params=mixed), {"streams": streams or data.num_clients}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  slabs=("params",) if down is None else ("params", "ef_dl"))
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        if state["streams"] is None:
            rows = aggregation.masked_cohort_matrix(state["W"], co.idx, co.mask)
            n_streams = co.real
        else:  # only the clusters present in the cohort put a model on the downlink
            rows = aggregation.masked_clustered_rows(state["W"], state["labels"],
                                                     state["streams"], co.idx, co.mask)
            n_streams = int(np.unique(state["labels_host"][co.members]).size)
        if down is None:
            params = aggregation.mix_scatter_flat(state["params"], post, rows, co.idx, co.mask)
        else:  # each receiver's mix, delta-coded against its round-start row
            served, ef_dl = down(pc, ops.mix_aggregate(rows, post), co.rows["ef_dl"])
            out["ef_dl"] = aggregation.scatter_rows(state["ef_dl"], co.idx, ef_dl, co.real)
            params = aggregation.scatter_rows(state["params"], co.idx, served, co.real)
        return dict(state, params=params, **out), {"streams": n_streams}

    return Strategy(
        name="ucfl" if num_streams is None else f"ucfl_k{num_streams}",
        init=init, round=common.cohort_round(dense, masked, transport=cfg.transport),
        eval_params=lambda s: layout.unravel(s["params"]),
        comm_scheme="unicast" if num_streams is None else "groupcast",
        num_streams=None if num_streams in (None, "auto") else num_streams,
        wire_schema=schema,
    )
