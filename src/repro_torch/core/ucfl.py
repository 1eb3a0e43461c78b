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
the special round's statistics; ``abuf`` the buffered-async server's
pending uploads, created by the first buffered round. The dense round
mixes the whole slab in ONE ``mix_aggregate`` launch (the rule is
column-independent), where the reference launches once per leaf.

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

Streaming W refresh (``FedConfig.w_refresh``): the state also holds
``refresh``, the slab-wide (m, dim_aligned) unit-direction buffer, Δ̂, σ̂²
and the staleness counters (:func:`repro_torch.core.similarity.init_refresh_state`,
one gram launch at init); every cohort round folds its uploads into them
and replaces ``W`` before the mix, and reports ``staleness_max`` and
``staleness_mean``. The labels of the clustered variant stay those of
init. The dense round never refreshes; a round nobody attends ages the
counters (``skip_round``).

Upload stage (``FedConfig.faults``/``robust``): after the wire stage and
before the refresh and the mix. The mix-scatter takes the final slots as
they are; under the delta-coded downlink the cohort's prefix is scattered
with a demoted slot's own rows, and the streams are counted on the card
from the final mask.

Buffered-async (``FedConfig.async_buffer``, not with ``w_refresh``): the
cohort's uploads (after the wire and upload stages) are deposited in the
state's ``abuf`` with the version of the row each client trained from
(``last_sync``); at a flush the B buffer rows are mixed with the masked
rules weighted by their staleness and scattered in ONE mix-scatter launch
over the buffer, whose live ids are in arrival order. The flush is a
device predicate folded into the mask, so no round syncs with the card.

Two-tier (``FedConfig.topology``, the clustered variant only): each edge
forms per-cluster partial sums of its members' uploads, one
``mix_aggregate`` launch over the (E·k, c) partial rules, and the PS sums
them and normalizes once; the served centroids are scattered at the
cohort's slots. It composes with the refresh.

Client mesh (``FedConfig.mesh``, ``shard_state``): the special round's
per-client gradients and σ² and every round's local SGD run on the rank's
block of the clients or slots and are all-gathered; W, the labels and the
(c, c) rules come out the same on every rank. Row-sharded, ``params`` and
the EF slabs (``ef``, ``ef_dl``) are the rank's blocks; W, ``collab``, the
refresh buffers and the async buffer's metadata stay whole on every rank,
and the buffer's ``upd`` rows are row-sharded too.

``ucfl_parallel`` (:func:`make_ucfl_parallel`) is the §V-E upper bound
of Fig. 6. The baselines the paper compares against are in
:mod:`repro_torch.core.baselines`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import aggregation, clustering, flat, similarity
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.data.loader import draw_permutations
from repro_torch.federated import async_buffer
from repro_torch.federated import client as fedclient
from repro_torch.federated import mesh as mesh_lib
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib
from repro_torch.kernels import ops


def compute_collaboration(apply_stacked, params0, data, *, var_batch_size=100,
                          chunk_size=None, layout=None, mesh=None):
    """Run the special pre-training round; returns the dict of §IV-A.

    Every (client, minibatch) pair of the fixed partition is one unit of
    the stacked model at θ⁰, so one backward pass gives all K minibatch
    gradients of a chunk of clients. ``chunk_size`` bounds that to
    (chunk·K, d) at a time; the chunk reduces at once to its (chunk, d)
    full gradients (their mean) and (chunk,) σ². ``mesh`` (a
    :mod:`repro_torch.federated.mesh` knob) shards the clients: each rank
    reduces its block (chunked within it) and the (m, W) full gradients
    and (m,) σ² are all-gathered before the one gram launch, which every
    rank then makes on the same rows.
    """
    layout = layout or flat.LayoutTable.build(params0)
    mesh = mesh_lib.resolve(mesh)
    theta0 = layout.ravel(params0)
    m, n = data.y.shape
    steps = n // var_batch_size
    used = steps * var_batch_size

    def stats(x, y):
        """(U, W) full gradients and (U,) σ² of the U clients of x, y."""
        fulls, sigs = [], []
        for sl in fedclient.chunks(y.shape[0], chunk_size):
            c = sl.stop - sl.start
            # each client's fixed partition (loader.fixed_partition), stacked
            xb = x[sl, :used].reshape((c, steps, var_batch_size) + tuple(x.shape[2:]))
            yb = y[sl, :used].reshape(c, steps, var_batch_size)
            # the slab's pad columns never reach the loss: their gradient is 0
            g = fedclient.minibatch_gradients(apply_stacked, layout, theta0.expand(c, -1), xb,
                                              yb)
            full = torch.mean(g, dim=1)
            fulls.append(full)
            sigs.append(similarity.sigma_sq(g[..., : layout.dim], full[:, : layout.dim]))
        return torch.cat(fulls).contiguous(), torch.cat(sigs)

    if mesh is not None and m % mesh.shards == 0:
        stats = mesh_lib.shard_clients(stats, mesh)
    # Δ from the slab-wide rows: 16-byte aligned, so the Gram kernel reads
    # them where they lie, and the zero columns add nothing to any sum
    full, sig = stats(data.x, data.y)
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
    if cfg.async_buffer is not None and cfg.w_refresh is not None:
        raise ValueError(
            "FedConfig.async_buffer and FedConfig.w_refresh cannot be "
            "combined yet: the streaming refresh consumes each barrier "
            "round's (pre, post) upload pair, which the async buffer "
            "does not retain (see ROADMAP)")
    if num_streams is None:
        topology_lib.unsupported(
            cfg.topology, "ucfl",
            "full personalization's Eq. 8 mix is per-client unicast — "
            "every receiver's row reads every cohort column, so the PS "
            "rule has no per-edge partial-sum factorization (use the "
            "clustered variant)")
    topo = topology_lib.check_composition(cfg.topology, f"ucfl_k{num_streams}",
                                          shard_state=cfg.shard_state,
                                          async_buffer=cfg.async_buffer)
    acfg = cfg.async_buffer
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    edge_arr = None if topo is None else topo.edge_array(dev)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    refresh = common.w_refresh_hook(cfg.w_refresh)
    if num_streams is None:
        schema = transport_lib.single_delta_schema(
            "ucfl", layout.dim, downlink=(transport_lib.Stream("personalized", layout.dim),))
    else:
        schema = transport_lib.single_delta_schema(
            f"ucfl_k{num_streams}", layout.dim,
            downlink=(transport_lib.Stream("centroids", layout.dim, coding="raw"),))
    up, down = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def init(gen, data, *, kmeans_init=None):
        """``kmeans_init`` (k, m) replaces the K-means++ seeds (parity
        tests pass the reference's)."""
        m = data.num_clients
        if topo is not None:
            topo.check_clients(m, "ucfl")
        collab = compute_collaboration(
            apply_stacked, params0, data, var_batch_size=var_batch_size,
            chunk_size=cfg.chunk_size, layout=layout, mesh=sops.mesh)
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
        state = {"params": layout.slab(params0, m), "W": w, "labels": labels,
                 "labels_host": labels_host, "streams": k, "collab": collab,
                 **common.wire_state(schema, cfg.transport, m, dev, dl_rows=m)}
        if refresh is not None:
            state["refresh"] = similarity.init_refresh_state(collab, m, width=layout.dim_aligned)
        return state

    def dense(state, data, gen, perms):
        # the dense round never refreshes: it stays the paper's compute-W-once round
        updated = local(state["params"], data.x, data.y, gen=gen, perms=perms)
        streams = state["streams"]
        if streams is None:
            mixed = aggregation.user_centric(updated, state["W"])
        else:
            mixed = aggregation.clustered(updated, state["W"], state["labels"], streams)
        return dict(state, params=mixed), {"streams": streams or data.num_clients}

    def count_streams(state, co, fmask, staged):
        """The round's downlink streams: its real members (full
        personalization) or the clusters they belong to, on the host; under
        the upload stage, from the final mask on the card."""
        k = state["streams"]
        if not staged:
            if k is None:
                return co.real
            return int(np.unique(state["labels_host"][co.members]).size)
        if k is None:
            return torch.sum(fmask)
        return common.groups_present(state["labels"][co.safe], k, fmask)

    def mix_rows(state, w, idx, mask, weights=None):
        """The masked rules of the slots ``idx``/``mask``: Eq. 8's (c, c)
        rows, or the centroid rules of the clusters present (§IV-B);
        ``weights`` the buffered flush's staleness discounts."""
        if state["streams"] is None:
            return aggregation.masked_cohort_matrix(w, idx, mask, weights)
        return aggregation.masked_clustered_rows(w, state["labels"], state["streams"], idx,
                                                 mask, weights)

    def tiered_serve(state, w, post, idx, mask):
        """The two-tier §IV-B mix of the (c, d) uploads: tier 1, each edge's
        per-cluster partial sums of its members' uploads, as one launch of
        the (E·k, c) partial rules (the raw centroid rules split by edge);
        tier 2, the PS sums the E partials and their masses and normalizes
        once. A slot whose centroid has no mass keeps its own upload, as in
        the flat rule. Returns the (c, d) served rows."""
        k, m = state["streams"], w.shape[0]
        fmask = mask.to(w.dtype)
        safe = aggregation.safe_gather_index(idx, m).long()
        lc = state["labels"].long()[safe]
        oc = F.one_hot(lc, k).to(w.dtype) * fmask[:, None]  # (c, k)
        cw = oc.T @ (w[safe][:, safe] * fmask[None, :])  # (k, c) raw rules
        eoh = topology_lib.edge_onehot(edge_arr, topo.num_edges, idx, mask)  # (c, E)
        rules = (eoh.T[:, None, :] * cw[None, :, :]).reshape(-1, cw.shape[1])  # (E·k, c)
        part = ops.mix_aggregate(rules, post).view(topo.num_edges, k, -1)
        massk = torch.sum(torch.sum(rules, dim=1).view(topo.num_edges, k), dim=0)  # (k,)
        cent = torch.sum(part, dim=0) / torch.clamp_min(massk, 1e-12)[:, None]
        return torch.where((massk > 1e-12)[lc][:, None], cent[lc], post)

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  slabs=("params",) if down is None else ("params", "ef_dl"),
                                  sops=sops)
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out, metrics = {}, {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        fidx, fmask, final = co.idx, co.mask, None
        if ustage is not None:
            post, fidx, fmask = common.upload(ustage, co, pc, post)
            final = fmask
        w = state["W"]
        if refresh is not None:
            # the decoded, guarded uploads at the pre-stage slots, under the final mask
            out["refresh"], w = refresh(pc, post, state["refresh"], co.idx, fmask, data.n,
                                        co.real)
            out["W"] = w
            metrics = common.staleness_metrics(out["refresh"])
        metrics["streams"] = count_streams(state, co, fmask, final is not None)
        if topo is not None:  # the fresh rules, if any, feed the same tiered serve
            served = tiered_serve(state, w, post, fidx, fmask)
            params = co.scatter(state["params"], common.kept(final, served, pc))
            return dict(state, params=params, **out), metrics
        rows = mix_rows(state, w, fidx, fmask)
        if down is None:
            params = sops.mix_scatter_flat(state["params"], post, rows, fidx, fmask)
        else:  # each receiver's mix, delta-coded against its round-start row
            ef_rows = co.rows["ef_dl"]
            served, ef_dl = down(pc, ops.mix_aggregate(rows, post), ef_rows)
            out["ef_dl"] = co.scatter(state["ef_dl"], common.kept(final, ef_dl, ef_rows))
            params = co.scatter(state["params"], common.kept(final, served, pc))
        return dict(state, params=params, **out), metrics

    def amasked(state, data, gen, idx, mask, perms):
        """The buffered round: the uploads, after the wire and upload
        stages (the deposit is what the server decoded, ``pre +
        dequant`` under a wire), land in the buffer with the version of the
        row they trained from; at a flush the rules of the B buffer slots,
        weighted by staleness, mix and scatter the buffer in one launch.
        Not a flush: the mask is all False and nothing is written."""
        m = data.num_clients
        abuf = common.state_async_buffer(state, acfg, m, len(idx), layout.dim, schema, dev, sops)
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        fidx, fmask = co.idx, co.mask
        if ustage is not None:
            post, fidx, fmask = common.upload(ustage, co, pc, post)
        # a client trains from its own row, untouched since the flush that last wrote it
        base_ver = abuf["last_sync"][aggregation.safe_gather_index(fidx, m).long()]
        abuf = async_buffer.deposit(abuf, post, fidx, fmask, base_ver, m,
                                    scatter=sops.buffer_scatter())
        flush = abuf["count"] >= int(acfg.flush_k)
        weights = async_buffer.staleness_weights(abuf, m, acfg.alpha)
        tau = async_buffer.staleness(abuf)
        applied = abuf["count"]
        b = acfg.capacity(len(idx))  # the buffer's own slots, before any shard padding
        bidx, bvalid = abuf["idx"][:b], async_buffer.valid_mask(abuf, m)[:b]
        rows = mix_rows(state, state["W"], bidx, bvalid, weights[:b])
        if state["streams"] is None:
            n_streams = torch.sum(bvalid)
        else:
            bsafe = aggregation.safe_gather_index(bidx, m).long()
            n_streams = common.groups_present(state["labels"][bsafe], state["streams"], bvalid)
        params = sops.mix_scatter_flat(state["params"], sops.buffer_gather(abuf)[:b], rows, bidx,
                                       bvalid & flush)
        abuf = async_buffer.flush_reset(abuf, m, flush)
        metrics = async_buffer.flush_metrics(flush, applied, tau, weights, abuf["count"])
        metrics["streams"] = torch.where(flush, n_streams, torch.zeros_like(n_streams))
        return dict(state, params=params, abuf=abuf, **out), metrics

    shard_keys = ("params", "ef", "ef_dl")  # those the state holds
    return Strategy(
        name="ucfl" if num_streams is None else f"ucfl_k{num_streams}",
        init=init,
        round=common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                  async_fn=amasked, async_cfg=acfg, topology=topo,
                                  sops=sops, shard_keys=shard_keys),
        eval_params=lambda s: layout.unravel(s["params"]),
        comm_scheme="unicast" if num_streams is None else "groupcast",
        num_streams=None if num_streams in (None, "auto") else num_streams,
        skip_round=None if refresh is None else common.refresh_skip_round,
        injects_faults=cfg.faults is not None,
        wire_schema=schema,
    )


@register("ucfl_parallel")
def make_ucfl_parallel(apply_stacked, params0, cfg: FedConfig = FedConfig(), *,
                       var_batch_size=100, device=None):
    """§V-E upper bound (Fig. 6): m parallel FL instances solving Eq. 4.

    Every participating client trains all m stream models each round (m×
    the compute and the uplink) and the PS applies Eq. 12,
    ``θ_i ← Σ_j w_ij θ_ij``, stream i's row product over the clients'
    updates of it. A (stream, client) pair is one unit of the stacked
    model; the streams train in groups of ``cfg.chunk_size`` units (m when
    None, the size of a ucfl round), and each group is mixed as soon as it
    is trained, so the (m, c, d) stack of updates is never held whole,
    unless the refresh needs it: its proxy is each slot's update of its own
    stream, and the refreshed W mixes every stream.

    The cohort round mixes each stream over the real cohort columns of W,
    renormalized (``masked_column_mixing``); a stream without mass on the
    cohort keeps its model. ``streams`` is m either way (every participant
    downloads all m models). ``round(..., perms=)`` takes the (m streams,
    m clients, epochs, ≥ steps·B) batch orders. The state is a new tensor
    each round (every stream's row is rewritten).

    Its wire has no single (c, d) upload slab: ``transport`` and
    ``faults``/``robust`` raise ``NotImplementedError`` at construction, as
    ``shard_state`` does (every stream's row is read each round). ``mesh``
    shards each group's (stream, client) units over the ranks.
    """
    if cfg.shard_state:
        raise NotImplementedError(
            "FedConfig.shard_state is not supported by ucfl_parallel: its "
            "(m, c) column mix reads every stream's row each round, so "
            "there is no O(c·d) row-routing to exploit (the m× cost is "
            "the point of this upper bound)")
    if cfg.faults is not None or cfg.robust is not None:
        raise NotImplementedError(
            "FedConfig.faults/robust are not supported by ucfl_parallel: "
            "the m× per-stream update stack has no single (c, d) upload "
            "slab for the fault/robust stage to rewrite — this idealized "
            "§V-E upper bound assumes honest clients by construction")
    transport_lib.unsupported(
        cfg.transport, "ucfl_parallel",
        "the m× per-stream update stack has no single (c, d) upload "
        "slab to quantize — the m× uplink cost is the point of this "
        "upper bound")
    topology_lib.unsupported(
        cfg.topology, "ucfl_parallel",
        "the §V-E upper bound mixes EVERY stream over every cohort "
        "column with the (m, c) column-sliced W — there are no per-edge "
        "partial aggregates for an edge tier to ship")
    sops = common.StateOps(cfg.mesh)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    refresh = common.w_refresh_hook(cfg.w_refresh)

    def init(gen, data):
        m = data.num_clients
        collab = compute_collaboration(
            apply_stacked, params0, data, var_batch_size=var_batch_size,
            chunk_size=cfg.chunk_size, layout=layout, mesh=sops.mesh)
        state = {"params": layout.slab(params0, m), "W": collab["W"]}
        if refresh is not None:
            state["refresh"] = similarity.init_refresh_state(collab, m, width=layout.dim_aligned)
        return state

    def stream_perms(gen, perms, m, n):
        if perms is None:
            if gen is None:
                raise ValueError("ucfl_parallel's round needs gen= or perms=")
            perms = draw_permutations(gen, m * m, cfg.epochs, n, device=dev).view(
                m, m, cfg.epochs, n)
        if tuple(perms.shape[:2]) != (m, m):
            raise ValueError(f"perms {tuple(perms.shape)}: ucfl_parallel takes the (m streams, "
                             "m clients, epochs, n) orders of all clients")
        return perms

    def groups(params, x, y, perms):
        """Yield (stream slice, (g, c, d) updates): every one of the c
        clients of ``x``/``y`` trains each stream of the group from its
        row, on ``perms`` (m, c, epochs, n)."""
        m, c = params.shape[0], y.shape[0]
        for sl in fedclient.chunks(m, max(1, (cfg.chunk_size or m) // c)):
            g = sl.stop - sl.start
            xs = x.expand((g,) + tuple(x.shape)).reshape((g * c,) + tuple(x.shape[1:]))
            ys = y.expand((g,) + tuple(y.shape)).reshape(g * c, -1)
            ps = perms[sl].reshape((g * c,) + tuple(perms.shape[2:]))
            upd = local(params[sl].repeat_interleave(c, dim=0), xs, ys, perms=ps)
            yield sl, upd.view(g, c, -1)

    def mix(w_rows, upd):
        """Eq. 12 for a group: (g, c)·(g, c, d) -> (g, d), in f32."""
        return torch.bmm(w_rows.unsqueeze(1), upd).squeeze(1)

    def dense(state, data, gen, perms):
        params, w = state["params"], state["W"]
        m, n = data.y.shape
        perms = stream_perms(gen, perms, m, n)
        new = torch.empty_like(params)
        for sl, upd in groups(params, data.x, data.y, perms):
            new[sl] = mix(w[sl], upd)
        return dict(state, params=new), {"streams": m}

    def masked(state, data, gen, idx, mask, perms):
        params = state["params"]
        m, n = data.y.shape
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops, slabs=() if refresh is None else ("params",))
        perms = stream_perms(gen, perms, m, n)[:, co.safe]
        if refresh is None:
            wc, alive = aggregation.masked_column_mixing(state["W"], co.idx, co.mask)
            new = torch.empty_like(params)
            for sl, upd in groups(params, co.x, co.y, perms):
                new[sl] = torch.where(alive[sl, None], mix(wc[sl], upd), params[sl])
            return dict(state, params=new), {"streams": m}
        stack = torch.cat([upd for _, upd in groups(params, co.x, co.y, perms)])
        # client j's own trajectory is stream idx_j: its update of it is the proxy
        own = stack[co.safe, torch.arange(co.safe.shape[0], device=dev)]
        buffers, w = refresh(co.rows["params"], own, state["refresh"], co.idx, co.mask, data.n,
                             co.real)
        wc, alive = aggregation.masked_column_mixing(w, co.idx, co.mask)
        new = torch.where(alive[:, None], mix(wc, stack), params)
        return (dict(state, params=new, W=w, refresh=buffers),
                {"streams": m, **common.staleness_metrics(buffers)})

    return Strategy(
        name="ucfl_parallel", init=init,
        round=common.cohort_round(dense, masked, async_cfg=cfg.async_buffer, sops=sops),
        eval_params=lambda s: layout.unravel(s["params"]),
        comm_scheme="unicast",
        skip_round=None if refresh is None else common.refresh_skip_round,
    )
