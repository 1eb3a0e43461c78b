"""The cohort engine every strategy's ``round`` is built from, and the
pieces the baselines share.

  * :func:`cohort_round` — the one dispatch point: normalizes the cohort
    argument to the padded ``(indices, mask)`` contract
    (:func:`repro_torch.federated.participation.as_cohort`), routes to the
    dense or the masked path, and attaches the host-side ``cohort_size``.
  * :func:`gather_cohort` — the padded cohort's contract in one place:
    the slots on the card, their clamped ids, one ``cohort_gather``
    launch for each slab the strategy trains from, the slots' data and
    their batch orders. Each strategy's masked round starts with it,
    trains the gathered rows, and ends in its mix (the fused
    ``masked_mix_scatter``, the FedAvg broadcast, or
    :func:`repro_torch.core.aggregation.scatter_rows` of the real slots).
  * :func:`cohort_keys` — client-indexed batch orders, so that a slot's
    randomness depends only on its client id and pad slots stay
    invisible.
  * :func:`make_fedavg_masked_round` — the FedAvg family's masked round:
    the n-weighted mean of the real uploads, broadcast to every row.
  * :func:`wire_stages`, :func:`wire_state` and :func:`uplink` — the
    quantized wire (``FedConfig.transport``): a strategy's uplink and
    downlink stages, the EF slabs they add to its state, and the uplink
    stage of a cohort round, after local SGD and before the mix.
  * :func:`group_mixing_matrix` / :func:`group_average` — per-group FedAvg
    (CFL's clusters, the Oracle's true groups).
  * :func:`upload_stage`, :func:`upload` and :func:`kept` — the upload
    stage (``FedConfig.faults``/``robust``): fault injection, the finite
    guard and the robust rule on the uploads, after the wire stage and
    before the mix. It returns the final slot arrays, whose mask may have
    holes mid-cohort (drops, the guard, trimmed-mean and Krum demote
    slots). The fused mix-scatter takes them as they are; every plain
    scatter writes the cohort's pre-stage prefix (host-counted) with
    :func:`kept` rows, a demoted slot getting its own round-start row
    back, so no path syncs with the card for the final mask. With both
    knobs off no stage runs, and every path keeps its host counts.
  * :func:`w_refresh_hook`, :func:`staleness_metrics` and
    :func:`refresh_skip_round` — the streaming W refresh
    (``FedConfig.w_refresh``) of the W-owning strategies.
  * :func:`state_async_buffer`, :func:`make_fedavg_async_round` and
    :func:`fedavg_async_wrapper` — the buffered-async server
    (``FedConfig.async_buffer``, :mod:`repro_torch.federated.async_buffer`):
    :func:`cohort_round` routes every cohort round to the strategy's
    buffered body, and the FedAvg family's banks deltas and adds their
    staleness-weighted mean at a flush, predicated on the card.
  * :func:`tiered_fedavg_weights` and :func:`fedavg_mix_closure` — the
    FedAvg family's mix, flat or over a two-tier
    :class:`~repro_torch.federated.topology.Topology`
    (``FedConfig.topology``): tier-1 edge aggregates and the tier-2
    combine, each one ``mix_aggregate`` launch.

In place: on the card the masked round writes the cohort rows of the
``params`` slab (and the refresh buffers, and the async buffer's rows) in
place, the port's analogue of the reference's buffer donation. A caller
that keeps the pre-round state alive (a warm-up, an A/B comparison from
one start state) runs the round on
:func:`repro_torch.federated.simulation.clone_state` of it.

Layouts (``FedConfig.mesh``, ``FedConfig.shard_state``): every row
movement against the (m, ·) state goes through the strategy's
:class:`StateOps`, replicated (each rank holds the whole slab; bit for bit
the mesh-free engine) or row-sharded (each rank holds its (m/s, ·) block;
:mod:`repro_torch.federated.mesh`). :func:`cohort_round` pads every
cohort to a shard multiple and commits the state's ``shard_keys`` slabs to
the rank's block before the round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import aggregation, flat, pytree, similarity
from repro_torch.data.loader import draw_permutations
from repro_torch.device import resolve_device
from repro_torch.federated import async_buffer
from repro_torch.federated import client as fedclient
from repro_torch.federated import faults as faults_lib
from repro_torch.federated import mesh as mesh_lib
from repro_torch.federated import participation
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib
from repro_torch.kernels import ops


def prepare(params0, device):
    """``params0`` on the strategy's device (CUDA unless told otherwise)
    and its slab layout."""
    dev = resolve_device(device)
    params0 = pytree.tree_map(lambda v: v.to(dev), params0)
    return params0, flat.LayoutTable.build(params0), dev


def local_sgd(apply_stacked, layout, cfg, *, grad_hook=None, mesh=None):
    """The federated ClientUpdate at ``cfg``'s hyperparameters, its client
    axis sharded over ``mesh`` (the strategy's resolved ``FedConfig.mesh``)."""
    return fedclient.make_federated_local_sgd(
        apply_stacked, layout, lr=cfg.lr, momentum=cfg.momentum, epochs=cfg.epochs,
        batch_size=cfg.batch_size, chunk_size=cfg.chunk_size, grad_hook=grad_hook, mesh=mesh)


def device_slots(idx, mask, dev):
    """The cohort's host slots as (idx int32, mask bool) on ``dev``, in one
    copy; from pinned memory it does not block the host as a copy from
    pageable memory would."""
    c = len(idx)
    slots = torch.from_numpy(np.concatenate([idx, mask]).astype(np.int32))
    if dev.type == "cuda":
        slots = slots.pin_memory().to(dev, non_blocking=True)
    return slots[:c], slots[c:].bool()


def group_mixing_matrix(assignment, n):
    """Row-stochastic W of per-group FedAvg (CFL, Oracle):
    W[i, j] = n_j · 1[a_i == a_j] / Σ_{a_k == a_i} n_k."""
    same = (assignment[:, None] == assignment[None, :]).to(torch.float32)
    w = same * n.to(torch.float32)[None, :]
    return w / torch.sum(w, dim=1, keepdim=True)


def group_average(stacked, assignment, n):
    """Each client gets its group's n-weighted mean: one ``mix_aggregate``
    launch with k = m over the slab."""
    return aggregation.user_centric(stacked, group_mixing_matrix(assignment, n))


class StateOps:
    """The layout of the (m, ·) stacked server state over the client mesh.

    One object a strategy, built from the ``FedConfig`` knobs
    (``StateOps(cfg.mesh, cfg.shard_state)``), so every gather, scatter and
    mix against the stacked state goes through one dispatch point:

      * replicated (``shard_state=False``, the default): each rank holds
        the whole slab and every method is the plain helper
        (:func:`repro_torch.core.aggregation.cohort_gather`,
        ``scatter_rows``, ``mix_scatter_flat``, :func:`fedavg_masked_mix`),
        bit for bit the engine without a mesh;
      * row-sharded (``shard_state=True``): rank k holds rows [k·m/s,
        (k+1)·m/s) of each slab its strategy names (``shard_keys``); the
        gather assembles the cohort with a (c, W) SUM all-reduce, the
        scatter and the mix-scatter rewrite only the owner's block, and the
        async flush's all-gather of its (B, W) rows is the one model-sized
        collective besides. Requires a mesh and ``m % num_shards == 0``.

    Cohort-shaped values (the (c, ·) gathered rows, the (c, c) rules, the
    slot arrays) are the same on every rank in both layouts; only (m, ·)
    and (B, ·) stacked state changes layout.
    """

    def __init__(self, mesh=None, shard_state: bool = False):
        mesh = mesh_lib.resolve(mesh)
        if shard_state and mesh is None:
            raise ValueError(
                "FedConfig.shard_state requires a mesh (FedConfig.mesh): "
                "row-sharding partitions the state across the clients "
                "mesh's devices")
        self.mesh = mesh
        self.sharded = bool(shard_state)

    # ---- cohort row movement

    def gather(self, full, safe):
        """The cohort gather ``full[safe]`` (``safe`` int32, pre-clamped):
        one ``cohort_gather`` launch, on the rank's block when sharded."""
        if self.sharded:
            return mesh_lib.shard_gather_rows(full, safe, self.mesh)
        return aggregation.cohort_gather(full, safe)

    def scatter(self, full, co, rows):
        """``full[co.idx[i]] = rows[i]`` for the cohort's real slots
        (:class:`CohortRows`); pads never write, and a sharded rank writes
        the slots it owns."""
        if self.sharded:
            return mesh_lib.shard_scatter_rows(full, co.members, rows, self.mesh)
        return aggregation.scatter_rows(full, co.idx, rows, co.real)

    def row0(self, full):
        """The state's global row 0, (1, W): the shared reference of a
        broadcast-uniform slab's delta-coded downlink."""
        if self.sharded:
            return self.gather(full, torch.zeros((1,), dtype=torch.int32, device=full.device))
        return full[0:1]

    def row_mean(self, full, m):
        """The mean of all m rows of ``full``, (1, W). With more than one
        shard both layouts add the s row blocks' column sums in rank order
        (:func:`repro_torch.federated.mesh.row_mean`), so they agree bit for
        bit; without a mesh, on one shard, or where the shards do not divide
        m (replicated), it is ``torch.mean``."""
        if self.mesh is None or self.mesh.shards == 1 or m % self.mesh.shards:
            return torch.mean(full, dim=0, keepdim=True)
        if self.sharded:
            return mesh_lib.row_mean(full, self.mesh, m)
        return mesh_lib.block_mean(full, self.mesh)

    # ---- fused PS mixes

    def mix_scatter(self, full, cohort_updated, rows, idx, mask):
        """:func:`repro_torch.core.aggregation.mix_scatter` in either layout."""
        return self.mix_scatter_flat(full, pytree.stacked_ravel(cohort_updated), rows, idx, mask)

    def mix_scatter_flat(self, full, flat_c, rows, idx, mask):
        """:func:`repro_torch.core.aggregation.mix_scatter_flat` in either
        layout. Sharded, the (c, c) × (c, W) mix is computed the same on
        every rank and each rank's kernel writes only the rows of its block
        (localized ids; the rest drop on the local sentinel)."""
        if not self.sharded:
            return aggregation.mix_scatter_flat(full, flat_c, rows, idx, mask)
        update = mesh_lib.shard_block_update(
            lambda block, loc, lm, fc, w: aggregation.mix_scatter_flat(block, fc, w, loc, lm),
            self.mesh)
        return update(full, idx, mask, flat_c, rows)

    def fedavg_mix(self, params, updated, idx, mask, n, *, dstage=None, ef_dl=None):
        """:func:`fedavg_masked_mix` in either layout: the (1, c) mix is the
        same on every rank, broadcast over the rank's rows."""
        return fedavg_masked_mix(params, updated, idx, mask, n, dstage=dstage, ef_dl=ef_dl,
                                 row0=None if dstage is None else self.row0(params))

    # ---- commits (the state entering a round)

    def commit_state(self, state, shard_keys, m):
        """The state with its ``shard_keys`` (m, ·) slabs and the async
        buffer's rows cut to this rank's block, and marked row-sharded
        (``mesh.ROW_KEY``). The identity when replicated, and for a state
        already committed."""
        if not self.sharded:
            return state
        out = dict(state)
        for k in shard_keys:
            if state.get(k) is not None:
                out[k] = mesh_lib.commit_rows(state[k], self.mesh, m)
        if state.get("abuf") is not None:
            out["abuf"] = self.commit_buffer(state["abuf"])
        out[mesh_lib.ROW_KEY] = mesh_lib.row_mark(self.mesh, out, shard_keys)
        return out

    # ---- the buffered-async buffer

    @property
    def buffer_shards(self) -> int:
        """The shard count the async buffer's B slots must divide by."""
        return mesh_lib.num_shards(self.mesh) if self.sharded else 1

    def buffer_scatter(self):
        """The deposit hook of :func:`repro_torch.federated.async_buffer.deposit`:
        each upload row lands in its owner rank's block of the row-sharded
        ``upd`` (the block's spare row takes the rest). None (the plain
        write) when replicated."""
        if not self.sharded:
            return None
        rank = self.mesh.rank

        def scatter(upd, dest, rows):
            loc, _ = mesh_lib._localize(dest, upd.shape[0] - 1, rank)
            out = upd if upd.is_cuda else upd.clone()
            return out.index_copy_(0, loc, rows.to(out.dtype))

        return scatter

    def buffer_gather(self, buf):
        """The (B, W) buffer rows on every rank, for a flush: the all-gather
        of the row-sharded blocks, each without its spare row (the async
        engine's one model-sized collective), or the rows themselves when
        replicated."""
        if self.sharded:
            return mesh_lib.all_gather_rows(buf["upd"][:-1], self.mesh)
        return async_buffer.rows(buf)

    def commit_buffer(self, buf):
        """The buffer with its (B + 1, W) ``upd`` cut to this rank's (B/s, W)
        block and a spare row; the metadata (idx, ver, count, version,
        last_sync) stays whole on every rank."""
        if not self.sharded:
            return buf
        b = buf["idx"].shape[0]
        upd = buf["upd"]
        if upd.shape[0] != b + 1 or self.mesh.shards == 1:
            return buf
        lo, hi = self.mesh.block(b)
        return dict(buf, upd=torch.cat([upd[lo:hi], upd.new_zeros((1, upd.shape[1]))]))


def cohort_round(dense_fn, masked_fn, *, transport=None, stage=None, async_fn=None,
                 async_cfg=None, topology=None, sops, shard_keys=("params",)):
    """Build ``round(state, data, gen=None, cohort=None, *, perms=None)``.

    ``dense_fn(state, data, gen, perms) -> (state, metrics)`` is the full
    participation path; ``masked_fn(state, data, gen, idx, mask, perms)``
    the padded-cohort path, with ``idx``/``mask`` the host numpy slot
    arrays (so wrappers can count host-side metrics without a device
    sync). ``cohort`` is None (dense), a
    :class:`~repro_torch.federated.participation.Cohort`, or a plain index
    array (an unpadded all-real cohort). With ``transport`` (the
    strategy's ``FedConfig.transport``) a dense round raises
    ``ValueError``: the quantized wire compresses the cohort's uploads.
    With ``stage`` (the strategy's :func:`upload_stage`) a dense round
    raises ``ValueError`` too, and every cohort round advances the state's
    ``fault_round``, the counter the fault draws are keyed on.

    ``async_cfg`` (``FedConfig.async_buffer``) routes every cohort round to
    ``async_fn``, the strategy's buffered body (same signature as
    ``masked_fn``); without one the strategy has no buffered rule and
    construction raises ``NotImplementedError``. A dense round under it
    raises ``ValueError``, as under ``topology`` (the strategy's checked
    ``FedConfig.topology``, whose tiered mix its masked body closes over).

    ``sops`` (the strategy's :class:`StateOps`) over a mesh pads every
    cohort to a slot count the shard count divides, with sentinel slots,
    before the masked path sees it. Row-sharded, it commits the state's
    ``shard_keys`` slabs to the rank's block before every round
    (:meth:`StateOps.commit_state`), and a dense round raises
    ``ValueError``: its broadcast is the O(m·d) traffic the row-sharded
    layout removes.
    """
    if async_cfg is not None and async_fn is None:
        raise NotImplementedError(
            "FedConfig.async_buffer is set but this strategy has no "
            "buffered-async aggregation rule (supported: ucfl "
            "full/clustered and the FedAvg family — strategies whose PS "
            "step is the masked row aggregation)")
    fn = masked_fn if async_cfg is None else async_fn
    mesh, sharded = sops.mesh, sops.sharded

    def round(state, data, gen=None, cohort=None, *, perms=None):
        m = data.num_clients
        cohort = participation.as_cohort(cohort, m)
        if cohort is None:
            if sharded:
                raise ValueError(
                    "FedConfig.shard_state requires cohort rounds: "
                    "cohort=None is the dense full-participation path, "
                    "whose broadcast is the O(m·d) traffic row-sharding "
                    "removes — pass a participation config (or drop "
                    "shard_state)")
            if async_cfg is not None:
                raise ValueError(
                    "the buffered-async engine processes arrival cohorts; "
                    "cohort=None is the bulk-synchronous dense path — pass "
                    "a participation config (or drop FedConfig.async_buffer)")
            if stage is not None:
                raise ValueError(
                    "FedConfig.faults/robust require cohort rounds: the "
                    "injection and robust rewrites are fixed-shape masked "
                    "slot transforms with no dense counterpart — pass a "
                    "participation config (or drop faults/robust)")
            if transport is not None:
                raise ValueError(
                    "FedConfig.transport requires cohort rounds: "
                    "quantization compresses the masked upload stage, and "
                    "the dense full-participation path has no upload — "
                    "pass a participation config (or drop transport)")
            if topology is not None:
                raise ValueError(
                    "FedConfig.topology requires cohort rounds: the "
                    "two-tier engine partitions the cohort's upload slots "
                    "over edge aggregators, and the dense "
                    "full-participation path has no per-edge upload stage "
                    "— pass a participation config (or drop topology)")
            state, metrics = dense_fn(state, data, gen, perms)
            size = m
        else:
            if mesh is not None:
                cohort = mesh_lib.pad_cohort(cohort, mesh, m)
            if sharded:
                state = sops.commit_state(state, shard_keys, m)
            rnd = state.get("fault_round", 0)
            state, metrics = fn(state, data, gen, cohort.indices, cohort.mask, perms)
            if stage is not None:
                state = dict(state, fault_round=rnd + 1)
            if sharded:  # a body that builds a new dict keeps the mark
                state = dict(state, **{mesh_lib.ROW_KEY: mesh_lib.row_mark(sops.mesh, state,
                                                                             shard_keys)})
            size = len(cohort)
        return state, {**metrics, "cohort_size": size}

    return round


def cohort_keys(gen, m, safe, *, epochs, n, perms=None):
    """Client-indexed batch orders of the cohort slots.

    The (m, epochs, n) permutations of ALL m clients come from the round's
    generator (or the injected ``perms``), and the slots take the rows at
    ``safe`` (int64, on the permutations' device). A slot's order thus
    depends only on its client id, not on the slot count: a padded cohort
    trains its real slots exactly as the unpadded one, and a full cohort
    draws what the dense round draws.
    """
    if perms is None:
        if gen is None:
            raise ValueError("the cohort round needs gen= or perms=")
        perms = draw_permutations(gen, m, epochs, n, device=safe.device)
    if perms.shape[0] != m:
        raise ValueError(f"perms has {perms.shape[0]} rows for m={m} clients; the "
                         "cohort round takes the (m, epochs, n) orders of all clients")
    return perms[safe]


@dataclasses.dataclass(frozen=True)
class CohortRows:
    """A padded cohort's slots and gathered rows, on the slab's device.

    ``idx`` (c,) int32 client ids, pads at m, and ``mask`` (c,) bool are
    what the kernels take; ``safe`` (c,) int64 clamps the pads to m − 1;
    ``members`` are the real ids on the host, the slots' sorted prefix;
    ``rows`` maps a state key to its gathered (c, dim_aligned) rows, a
    copy; ``x``/``y`` are the slots' data; ``rnd`` the state's
    ``fault_round`` (0 without the upload stage); ``sops`` the state's
    layout."""

    idx: torch.Tensor
    mask: torch.Tensor
    safe: torch.Tensor
    members: np.ndarray
    rows: dict
    x: torch.Tensor
    y: torch.Tensor
    gen: torch.Generator | None
    m: int
    epochs: int
    rnd: int
    sops: StateOps

    def scatter(self, full, rows):
        """``full[idx[i]] = rows[i]`` at the real slots, in the state's
        layout (:meth:`StateOps.scatter`)."""
        return self.sops.scatter(full, self, rows)

    @property
    def real(self):
        """The real slots, counted on the host."""
        return len(self.members)

    def keys(self, perms=None, *, n=None):
        """The slots' (c, epochs, n) batch orders (:func:`cohort_keys`),
        ``n`` the samples a client trains on (all of ``y``'s by default)."""
        return cohort_keys(self.gen, self.m, self.safe, epochs=self.epochs,
                           n=self.y.shape[1] if n is None else n, perms=perms)


def gather_cohort(state, data, gen, idx, mask, *, dev, epochs, sops, slabs=("params",)):
    """The start of every masked round: the host slots ``idx``/``mask``
    on ``dev``, one ``cohort_gather`` launch for each key of ``state`` in
    ``slabs`` and for the uplink EF slab ``ef`` where the state holds one
    (a quantized wire), in the layout of ``sops`` (the strategy's
    :class:`StateOps`), and the slots' data, as a :class:`CohortRows`."""
    m = data.num_clients
    idx_t, mask_t = device_slots(idx, mask, dev)
    safe32 = aggregation.safe_gather_index(idx_t, m)
    safe = safe32.long()
    slabs = tuple(slabs) + (("ef",) if "ef" in state else ())
    rows = {k: sops.gather(state[k], safe32) for k in slabs}
    return CohortRows(idx_t, mask_t, safe, idx[mask], rows, data.x[safe], data.y[safe], gen, m,
                      epochs, state.get("fault_round", 0), sops)


def wire_stages(schema, transport):
    """The (uplink, downlink) stages of ``schema`` under ``transport``
    (:func:`repro_torch.federated.transport.make_wire_stage`); each is None
    when ``transport`` is, or when its direction has no ``delta`` stream."""
    return (transport_lib.make_wire_stage(schema, transport, "uplink"),
            transport_lib.make_wire_stage(schema, transport, "downlink"))


def wire_state(schema, transport, m, dev, *, dl_rows=1):
    """The EF slabs a quantized wire adds to a strategy's state: ``ef``,
    (m, uplink width), and, where the downlink has a ``delta`` stream,
    ``ef_dl``, (``dl_rows``, downlink width): one row for a broadcast, m
    for one a receiver. Empty when ``transport`` is None."""
    up, down = wire_stages(schema, transport)
    out = {}
    if up is not None:
        out["ef"] = torch.zeros((m, schema.width_aligned("uplink")), device=dev)
    if down is not None:
        out["ef_dl"] = torch.zeros((dl_rows, schema.width_aligned("downlink")), device=dev)
    return out


def upload_stage(cfg, schema):
    """The strategy's upload stage (``cfg.faults``, ``cfg.robust``) on its
    uplink wire ``schema``, or None when both knobs are off
    (:func:`repro_torch.federated.faults.upload_stage`)."""
    return faults_lib.upload_stage(cfg.faults, cfg.robust, schema)


def upload(stage, co, pre, post):
    """The upload stage on the (c, W) wire rows ``pre`` (the round-start
    rows) and ``post`` (what the server decoded): returns ``(post', idx',
    mask')``, the final slot arrays on the card."""
    return stage(pre, post, co.idx, co.mask, co.m, co.rnd)


def kept(mask, new, old):
    """``new`` where the final ``mask`` keeps the slot, else ``old`` (the
    slot's round-start row): scattered at the pre-stage prefix, a demoted
    slot writes its own row back, bit for bit no write. ``mask`` None
    (no stage) keeps ``new``."""
    return new if mask is None else torch.where(mask[:, None], new, old)


def groups_present(group_c, k, mask):
    """How many of the ``k`` groups (clusters, true groups) hold a live
    slot: ``group_c`` the (c,) group of each slot, ``mask`` the final mask.
    A device scalar: counted on the card, with no sync."""
    present = F.one_hot(group_c.long(), k) * mask[:, None]
    return torch.sum(torch.amax(present, dim=0) > 0)


def w_refresh_hook(cfg):
    """The streaming W refresh of ``cfg`` (a
    :class:`repro_torch.core.similarity.RefreshConfig`), or None when off:
    ``hook(pre, post, refresh, idx, mask, n, real) -> (refresh', W')`` folds
    the (c, d) uploads' proxies ``pre − post`` (the uploads the round has
    already, so no extra bytes) into the buffers. Anything but a
    ``RefreshConfig`` raises ``TypeError``."""
    if cfg is None:
        return None
    if not isinstance(cfg, similarity.RefreshConfig):
        raise TypeError(f"FedConfig.w_refresh must be a RefreshConfig or None, "
                        f"got {type(cfg).__name__}")

    def hook(pre, post, refresh, idx, mask, n, real):
        return similarity.streaming_refresh(refresh, similarity.grad_proxy(pre, post), idx,
                                            mask, n, cfg=cfg, real=real)

    return hook


def staleness_metrics(refresh):
    """The refresh's round metrics: the (m,) staleness counters and their
    max and mean, device scalars (no sync in the round)."""
    stale = refresh["staleness"]
    return {"staleness": stale, "staleness_max": torch.max(stale),
            "staleness_mean": torch.mean(stale.to(torch.float32))}


def refresh_skip_round(state):
    """``Strategy.skip_round`` of a refreshing strategy: a round nobody
    attends ages every client's statistics by one (an all-masked
    ``staleness_update``)."""
    refresh = state["refresh"]
    return dict(state, refresh=dict(refresh, staleness=refresh["staleness"] + 1))


def uplink(stage, state, co, pre, post):
    """The uplink wire stage of a cohort round on the (c, W) rows ``pre``
    (what the clients started from) and ``post`` (what they trained):
    returns what the server decodes, ``post'``, and the state's new EF
    slab, the slots' residuals written back at the real slots."""
    post, ef_c = stage(pre, post, co.rows["ef"])
    return post, co.scatter(state["ef"], ef_c)


def fedavg_masked_mix(params, updated, idx, mask, n, *, dstage=None, ef_dl=None, row0=None):
    """Masked Eq. 1: the n-weighted mean of the real cohort uploads
    (``updated``, (c, d)), broadcast to every row of the ``params`` slab
    (or of the rank's block of it).

    ``n`` is the full (m,) dataset sizes: the pad sentinels are clamped
    against it. An all-masked cohort keeps the previous model instead of
    broadcasting the degenerate zero mix. This is the one sanctioned
    full-state write of the cohort engine; it returns a new tensor.

    With ``dstage``, the downlink stage of a ``delta`` broadcast, the mean
    is delta-coded against the receivers' shared reference ``row0``, the
    broadcast-uniform ``params``' global row 0 (``params[0:1]`` when None),
    with the server's (1, d) EF row ``ef_dl``; the result is then
    ``(params', ef_dl')``, and an all-masked cohort keeps both as they were.
    """
    safe = aggregation.safe_gather_index(idx, n.shape[0]).long()
    w = aggregation.masked_fedavg_weights(n[safe], mask)
    mixed = aggregation.user_centric(updated, w)  # (1, d)
    alive = torch.any(mask)
    if dstage is None:
        return mesh_lib.shard_broadcast_rows(params, mixed, alive)
    served, new_ef = dstage(params[0:1] if row0 is None else row0, mixed, ef_dl)
    return mesh_lib.shard_broadcast_rows(params, served, alive), torch.where(alive, new_ef, ef_dl)


def tiered_fedavg_weights(edge_arr, num_edges, slots, idx, mask, n):
    """Two-tier FedAvg weights over a padded cohort.

    Tier 1 is the masked rule per edge over the (E, s) per-edge cohorts of
    :func:`repro_torch.federated.topology.edge_partition`: each edge
    normalizes its own members' n mass (an empty edge gets zeros). Tier 2 is
    the same rule over the per-edge masses. Returns ``wpe`` (E, c), the
    tier-1 weights on the cohort's columns (``wpe @ uploads`` is the (E, d)
    slab of edge aggregates that crosses the backhaul), and ``w2`` (E,),
    so that ``w2[e]·wpe[e, j] = n_j / Σn``: the flat mean up to float
    association."""
    c = idx.shape[0]
    eidx, emask, eslot = topology_lib.edge_partition(edge_arr, num_edges, slots, idx, mask)
    esafe = aggregation.safe_gather_index(eidx, n.shape[0]).long()
    ne = (n[esafe] * emask).to(torch.float32)  # (E, s), pads 0
    w1 = ne / torch.clamp_min(torch.sum(ne, dim=1, keepdim=True), 1e-12)
    # pads point at column c, a spare sliced off
    wpe = torch.zeros((num_edges, c + 1), dtype=torch.float32, device=idx.device)
    wpe = wpe.scatter_(1, eslot.long(), w1)[:, :c]
    mass = torch.sum(ne, dim=1)  # (E,)
    w2 = aggregation.masked_fedavg_weights(mass, mass > 0)[0]
    return wpe, w2


def fedavg_mix_closure(*, sops, dstage=None, topology=None, device=None):
    """The FedAvg family's mix ``mix(params, updated, idx, mask, n,
    ef_dl=None)``: masked Eq. 1, broadcast back (:meth:`StateOps.fedavg_mix`
    in the layout of ``sops``). With ``dstage`` (the
    downlink stage of a ``delta`` broadcast) it returns ``(params',
    ef_dl')``. ``topology`` (a checked
    :class:`~repro_torch.federated.topology.Topology`, never with a
    row-sharded state) swaps the single global mean for the two-tier
    factorization of :func:`tiered_fedavg_weights` with the same broadcast
    and EF tail; None keeps the flat mix bit for bit."""
    if topology is not None:
        return _tiered_fedavg_mix_closure(topology, dstage=dstage, device=device)

    def mix(params, updated, idx, mask, n, ef_dl=None):
        return sops.fedavg_mix(params, updated, idx, mask, n, dstage=dstage, ef_dl=ef_dl)

    return mix


def _tiered_fedavg_mix_closure(topology, *, dstage=None, device=None):
    """The two-tier FedAvg mix (:func:`fedavg_mix_closure`): the tier-1 edge
    aggregates as one (E, c)·(c, d) ``mix_aggregate`` launch over the
    uploads, the tier-2 combine as one (1, E)·(E, d) launch, then the flat
    mix's broadcast (and downlink EF) tail. O(c·d + E·d) before the
    broadcast."""
    edge_arr = topology.edge_array(device)
    num_edges = topology.num_edges

    def mix(params, updated, idx, mask, n, ef_dl=None):
        slots = topology.slots_per_edge(idx.shape[0])
        wpe, w2 = tiered_fedavg_weights(edge_arr, num_edges, slots, idx, mask, n)
        agg = ops.mix_aggregate(wpe, updated)  # (E, d): the edge aggregates
        mixed = ops.mix_aggregate(w2[None, :], agg)  # (1, d)
        alive = torch.any(mask)
        if dstage is None:
            return torch.where(alive, mixed.expand_as(params), params)
        served, new_ef = dstage(params[0:1], mixed, ef_dl)
        return (torch.where(alive, served.expand_as(params), params),
                torch.where(alive, new_ef, ef_dl))

    return mix


def make_fedavg_masked_round(train, *, dev, epochs, schema, transport, sops, stage=None,
                             topology=None):
    """The FedAvg family's masked round (FedAvg, FedProx): the gathered
    rows trained by ``train(co, perms) -> (c, dim_aligned)``, ``co`` the
    :class:`CohortRows`, then the mix of :func:`fedavg_mix_closure` (flat,
    or two-tier under ``topology``). Under ``transport`` the uploads pass
    ``schema``'s uplink stage and the mean its downlink stage; then the
    upload ``stage`` (:func:`upload_stage`), whose final mask weighs the
    mean. ``sops`` is the state's layout. Returns ``masked(state, data,
    gen, idx, mask, perms)`` for :func:`cohort_round`."""
    up, down = wire_stages(schema, transport)
    mix = fedavg_mix_closure(dstage=down, topology=topology, device=dev, sops=sops)

    def masked(state, data, gen, idx, mask, perms):
        co = gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=epochs, sops=sops)
        pc = co.rows["params"]
        post = train(co, perms)
        out = {}
        if up is not None:
            post, out["ef"] = uplink(up, state, co, pc, post)
        fidx, fmask = co.idx, co.mask
        if stage is not None:
            post, fidx, fmask = upload(stage, co, pc, post)
        if down is None:
            new = mix(state["params"], post, fidx, fmask, data.n)
            return dict(state, params=new, **out), {"streams": 1}
        new, out["ef_dl"] = mix(state["params"], post, fidx, fmask, data.n, state["ef_dl"])
        return dict(state, params=new, **out), {"streams": 1}

    return masked


# ------------------------------------------------------- buffered-async path


def state_async_buffer(state, acfg, m, slots, dim, schema, device, sops):
    """The state's upload buffer, or a fresh one on ``device``: its slot
    count depends on the cohort's, which the strategy does not know at
    ``init``, so the first cohort round creates it, in the layout of
    ``sops`` (B padded to a shard multiple and ``upd`` cut to the rank's
    block when row-sharded). A warm-up on
    :func:`repro_torch.federated.simulation.clone_state` creates its own
    and throws it away."""
    buf = state.get("abuf")
    if buf is None:
        buf = sops.commit_buffer(async_buffer.init_buffer(
            acfg, m, slots, dim, schema=schema, device=device, shards=sops.buffer_shards))
    return buf


def make_fedavg_async_round(train, acfg, *, dev, epochs, schema, transport, sops, stage=None):
    """The FedAvg family's buffered-async round (FedAvg, FedProx).

    FedBuff's rule in delta form: the buffer banks the cohort's deltas
    ``θ_upload − θ_base`` (each against the global current at its
    upload), and a flush adds their n-weighted, staleness-discounted mean
    to the current global; with a fresh buffer that is the barrier mean up
    to float association (θ + Σ w̃(u − θ) against Σ w̃ u). Under the
    flush-the-whole-buffer rule the family's τ is 0 by construction: a
    version only moves at a flush, which clears every slot.

    ``train`` as in :func:`make_fedavg_masked_round`. The quantized uplink
    (with its EF) and the upload stage run before the deposit, so the
    buffer banks what the wire carried and no demoted row; the downlink
    stays raw f32. The flush is a device predicate: the add is
    ``where(flush, θ + step, θ)``, whose weights are 0, never NaN, when
    nothing is pending. ``sops`` is the state's layout: row-sharded, the
    deposits land in their owner's block of ``upd`` and every round
    all-gathers the buffer's rows for the predicated flush; the mean is
    taken over the buffer's own B slots, not the shard padding past them.
    Returns ``body(state, abuf, data, gen, idx, mask, perms) -> (state',
    abuf', metrics)``."""
    flush_k = int(acfg.flush_k)
    up, _ = wire_stages(schema, transport)

    def body(state, abuf, data, gen, idx, mask, perms):
        m = data.num_clients
        co = gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=epochs, sops=sops)
        pc = co.rows["params"]
        post = train(co, perms)
        out = {}
        if up is not None:
            post, out["ef"] = uplink(up, state, co, pc, post)
        fidx, fmask = co.idx, co.mask
        if stage is not None:
            post, fidx, fmask = upload(stage, co, pc, post)
        # a FedAvg client downloads the current global when sampled
        base_ver = abuf["version"].expand(fidx.shape)
        abuf = async_buffer.deposit(abuf, post - pc, fidx, fmask, base_ver, m,
                                    scatter=sops.buffer_scatter())
        flush = abuf["count"] >= flush_k
        weights = async_buffer.staleness_weights(abuf, m, acfg.alpha)
        tau = async_buffer.staleness(abuf)
        applied = abuf["count"]
        b = acfg.capacity(len(idx))  # the buffer's own slots, before any shard padding
        bsafe = aggregation.safe_gather_index(abuf["idx"][:b], m).long()
        w = aggregation.masked_fedavg_weights(data.n[bsafe], async_buffer.valid_mask(abuf, m)[:b],
                                              weights[:b])
        step = ops.mix_aggregate(w, sops.buffer_gather(abuf)[:b])  # (1, W)
        params = state["params"]
        params = torch.where(flush, params + step, params)
        abuf = async_buffer.flush_reset(abuf, m, flush)
        metrics = async_buffer.flush_metrics(flush, applied, tau, weights, abuf["count"])
        # one broadcast stream, when a flush ships a new global
        metrics["streams"] = flush.to(torch.int32)
        return dict(state, params=params, **out), abuf, metrics

    return body


def fedavg_async_wrapper(train, acfg, *, dev, epochs, schema, transport, sops, stage=None,
                         dim=None):
    """The FedAvg family's buffered cohort body for
    :func:`cohort_round`'s ``async_fn``, or None when ``acfg`` is:
    ``amasked(state, data, gen, idx, mask, perms)`` runs
    :func:`make_fedavg_async_round` on the state's lazily created buffer
    ``abuf`` (rows at ``schema``'s uplink width), in the layout of
    ``sops``."""
    if acfg is None:
        return None
    body = make_fedavg_async_round(train, acfg, dev=dev, epochs=epochs, schema=schema,
                                   transport=transport, stage=stage, sops=sops)

    def amasked(state, data, gen, idx, mask, perms):
        abuf = state_async_buffer(state, acfg, data.num_clients, len(idx), dim, schema, dev,
                                  sops)
        state, abuf, metrics = body(state, abuf, data, gen, idx, mask, perms)
        return dict(state, abuf=abuf), metrics

    return amasked
