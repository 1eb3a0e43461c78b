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

In place: on the card the masked round writes the cohort rows of the
``params`` slab in place, the port's analogue of the reference's buffer
donation. A caller that keeps the pre-round state alive (a warm-up, an
A/B comparison from one start state) runs the round on
:func:`repro_torch.federated.simulation.clone_state` of it.

Not ported yet: the mesh, ``shard_state`` and the reference's
``StateOps`` layout object (the mesh), and the async buffer, upload stage
(faults and robust rules) and topology branches (the engine knobs): each
is an item of ROADMAP queue A.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import aggregation, flat
from repro_torch.data.loader import draw_permutations
from repro_torch.device import resolve_device
from repro_torch.federated import client as fedclient
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


def cohort_round(dense_fn, masked_fn, *, transport=None):
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
    """

    def round(state, data, gen=None, cohort=None, *, perms=None):
        cohort = participation.as_cohort(cohort, data.num_clients)
        if cohort is None:
            if transport is not None:
                raise ValueError(
                    "FedConfig.transport requires cohort rounds: "
                    "quantization compresses the masked upload stage, and "
                    "the dense full-participation path has no upload — "
                    "pass a participation config (or drop transport)")
            state, metrics = dense_fn(state, data, gen, perms)
            size = data.num_clients
        else:
            state, metrics = masked_fn(state, data, gen, cohort.indices,
                                       cohort.mask, perms)
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
    copy; ``x``/``y`` are the slots' data."""

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
                      epochs)


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


def make_fedavg_masked_round(train, *, dev, epochs, schema, transport):
    """The FedAvg family's masked round (FedAvg, FedProx): the gathered
    rows trained by ``train(co, perms) -> (c, dim_aligned)``, ``co`` the
    :class:`CohortRows`, then :func:`fedavg_masked_mix` (the reference's
    ``fedavg_mix_closure`` without a topology). Under ``transport`` the
    uploads pass ``schema``'s uplink stage and the mean its downlink
    stage. Returns ``masked(state, data, gen, idx, mask, perms)`` for
    :func:`cohort_round`."""
    up, down = wire_stages(schema, transport)

    def masked(state, data, gen, idx, mask, perms):
        co = gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=epochs)
        post = train(co, perms)
        if up is None:
            new = fedavg_masked_mix(state["params"], post, co.idx, co.mask, data.n)
            return dict(state, params=new), {"streams": 1}
        post, ef = uplink(up, state, co, co.rows["params"], post)
        new, ef_dl = fedavg_masked_mix(state["params"], post, co.idx, co.mask, data.n,
                                       dstage=down, ef_dl=state["ef_dl"])
        return dict(state, params=new, ef=ef, ef_dl=ef_dl), {"streams": 1}

    return masked
