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

In place: on the card the masked round writes the cohort rows of the
``params`` slab (and the refresh buffers) in place, the port's analogue of
the reference's buffer donation. A caller that keeps the pre-round state
alive (a warm-up, an A/B comparison from one start state) runs the round
on :func:`repro_torch.federated.simulation.clone_state` of it.

Not ported yet: the mesh, ``shard_state`` and the reference's
``StateOps`` layout object (the mesh), and the async buffer and topology
branches (the engine knobs): each is an item of ROADMAP queue A.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import aggregation, flat, similarity
from repro_torch.data.loader import draw_permutations
from repro_torch.device import resolve_device
from repro_torch.federated import client as fedclient
from repro_torch.federated import faults as faults_lib
from repro_torch.federated import participation
from repro_torch.federated import transport as transport_lib


def prepare(params0, device):
    """``params0`` on the strategy's device (CUDA unless told otherwise)
    and its slab layout."""
    dev = resolve_device(device)
    params0 = {k: v.to(dev) for k, v in params0.items()}
    return params0, flat.LayoutTable.build(params0), dev


def local_sgd(apply_stacked, layout, cfg, *, grad_hook=None):
    """The federated ClientUpdate at ``cfg``'s hyperparameters."""
    return fedclient.make_federated_local_sgd(
        apply_stacked, layout, lr=cfg.lr, momentum=cfg.momentum, epochs=cfg.epochs,
        batch_size=cfg.batch_size, chunk_size=cfg.chunk_size, grad_hook=grad_hook)


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


def cohort_round(dense_fn, masked_fn, *, transport=None, stage=None):
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
    """

    def round(state, data, gen=None, cohort=None, *, perms=None):
        cohort = participation.as_cohort(cohort, data.num_clients)
        if cohort is None:
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
            state, metrics = dense_fn(state, data, gen, perms)
            size = data.num_clients
        else:
            rnd = state.get("fault_round", 0)
            state, metrics = masked_fn(state, data, gen, cohort.indices,
                                       cohort.mask, perms)
            if stage is not None:
                state = dict(state, fault_round=rnd + 1)
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
    ``fault_round`` (0 without the upload stage)."""

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
    rnd: int = 0

    @property
    def real(self):
        """The real slots, counted on the host."""
        return len(self.members)

    def keys(self, perms=None, *, n=None):
        """The slots' (c, epochs, n) batch orders (:func:`cohort_keys`),
        ``n`` the samples a client trains on (all of ``y``'s by default)."""
        return cohort_keys(self.gen, self.m, self.safe, epochs=self.epochs,
                           n=self.y.shape[1] if n is None else n, perms=perms)


def gather_cohort(state, data, gen, idx, mask, *, dev, epochs, slabs=("params",)):
    """The start of every masked round: the host slots ``idx``/``mask``
    on ``dev``, one ``cohort_gather`` launch for each key of ``state`` in
    ``slabs`` and for the uplink EF slab ``ef`` where the state holds one
    (a quantized wire), and the slots' data, as a :class:`CohortRows`."""
    m = data.num_clients
    idx_t, mask_t = device_slots(idx, mask, dev)
    safe32 = aggregation.safe_gather_index(idx_t, m)
    safe = safe32.long()
    slabs = tuple(slabs) + (("ef",) if "ef" in state else ())
    rows = {k: aggregation.cohort_gather(state[k], safe32) for k in slabs}
    return CohortRows(idx_t, mask_t, safe, idx[mask], rows, data.x[safe], data.y[safe], gen, m,
                      epochs, state.get("fault_round", 0))


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
    return post, aggregation.scatter_rows(state["ef"], co.idx, ef_c, co.real)


def fedavg_masked_mix(params, updated, idx, mask, n, *, dstage=None, ef_dl=None):
    """Masked Eq. 1: the n-weighted mean of the real cohort uploads
    (``updated``, (c, d)), broadcast to every row of the ``params`` slab.

    ``n`` is the full (m,) dataset sizes: the pad sentinels are clamped
    against it. An all-masked cohort keeps the previous model instead of
    broadcasting the degenerate zero mix. This is the one sanctioned
    full-state write of the cohort engine; it returns a new tensor.

    With ``dstage``, the downlink stage of a ``delta`` broadcast, the mean
    is delta-coded against the receivers' shared reference, row 0 of the
    broadcast-uniform ``params``, with the server's (1, d) EF row
    ``ef_dl``; the result is then ``(params', ef_dl')``, and an
    all-masked cohort keeps both as they were.
    """
    safe = aggregation.safe_gather_index(idx, n.shape[0]).long()
    w = aggregation.masked_fedavg_weights(n[safe], mask)
    mixed = aggregation.user_centric(updated, w)  # (1, d)
    alive = torch.any(mask)
    if dstage is None:
        return torch.where(alive, mixed.expand_as(params), params)
    served, new_ef = dstage(params[0:1], mixed, ef_dl)
    return (torch.where(alive, served.expand_as(params), params),
            torch.where(alive, new_ef, ef_dl))


def make_fedavg_masked_round(train, *, dev, epochs, schema, transport, stage=None):
    """The FedAvg family's masked round (FedAvg, FedProx): the gathered
    rows trained by ``train(co, perms) -> (c, dim_aligned)``, ``co`` the
    :class:`CohortRows`, then :func:`fedavg_masked_mix` (the reference's
    ``fedavg_mix_closure`` without a topology). Under ``transport`` the
    uploads pass ``schema``'s uplink stage and the mean its downlink
    stage; then the upload ``stage`` (:func:`upload_stage`), whose final
    mask weighs the mean. Returns ``masked(state, data, gen, idx, mask,
    perms)`` for :func:`cohort_round`."""
    up, down = wire_stages(schema, transport)

    def masked(state, data, gen, idx, mask, perms):
        co = gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=epochs)
        pc = co.rows["params"]
        post = train(co, perms)
        out = {}
        if up is not None:
            post, out["ef"] = uplink(up, state, co, pc, post)
        fidx, fmask = co.idx, co.mask
        if stage is not None:
            post, fidx, fmask = upload(stage, co, pc, post)
        if down is None:
            new = fedavg_masked_mix(state["params"], post, fidx, fmask, data.n)
            return dict(state, params=new, **out), {"streams": 1}
        new, out["ef_dl"] = fedavg_masked_mix(state["params"], post, fidx, fmask, data.n,
                                              dstage=down, ef_dl=state["ef_dl"])
        return dict(state, params=new, **out), {"streams": 1}

    return masked
