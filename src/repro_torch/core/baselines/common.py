"""The cohort engine every strategy's ``round`` is built from.

  * :func:`cohort_round` — the one dispatch point: normalizes the cohort
    argument to the padded ``(indices, mask)`` contract
    (:func:`repro_torch.federated.participation.as_cohort`), routes to the
    dense or the masked path, and attaches the host-side ``cohort_size``.
  * :func:`make_masked_round` — the masked round body on the slab: cohort
    gather (kernel ``cohort_gather``) -> local SGD of the cohort rows ->
    the strategy's mix, which ends in the fused ``masked_mix_scatter``.
  * :func:`cohort_keys` — client-indexed batch orders, so that a slot's
    randomness depends only on its client id and pad slots stay
    invisible.

In place: on the card the masked round writes the cohort rows of the
``params`` slab in place, the port's analogue of the reference's buffer
donation. A caller that keeps the pre-round state alive (a warm-up, an
A/B comparison from one start state) runs the round on
:func:`repro_torch.federated.simulation.clone_state` of it.

Not ported yet: the mesh, ``shard_state`` and the reference's
``StateOps`` layout object (the mesh), the async buffer, upload stage,
transport and topology branches (the engine knobs), and the baselines
themselves: each is an item of ROADMAP queue A.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.data.loader import draw_permutations
from repro_torch.federated import participation


def cohort_round(dense_fn, masked_fn):
    """Build ``round(state, data, gen=None, cohort=None, *, perms=None)``.

    ``dense_fn(state, data, gen, perms) -> (state, metrics)`` is the full
    participation path; ``masked_fn(state, data, gen, idx, mask, perms)``
    the padded-cohort path, with ``idx``/``mask`` the host numpy slot
    arrays (so wrappers can count host-side metrics without a device
    sync). ``cohort`` is None (dense), a
    :class:`~repro_torch.federated.participation.Cohort`, or a plain index
    array (an unpadded all-real cohort).
    """

    def round(state, data, gen=None, cohort=None, *, perms=None):
        cohort = participation.as_cohort(cohort, data.num_clients)
        if cohort is None:
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


def make_masked_round(train, mix, *, epochs):
    """The standard masked round body on the slab.

    ``train(pc, xc, yc, perms_c, *args) -> (c, dim_aligned)`` trains the
    gathered cohort rows; ``mix(params, post, idx, mask, *args) -> (m,
    dim_aligned)`` is the PS step. Returns ``body(params, idx, mask, x, y,
    gen, *args, perms=None)`` with ``idx`` (c,) int32 and ``mask`` (c,)
    bool on the slab's device. ``args`` (W, labels, n, ...) go to both.
    """
    def body(params, idx, mask, x, y, gen, *args, perms=None):
        m, n = y.shape
        safe32 = aggregation.safe_gather_index(idx, m)
        safe = safe32.long()
        perms_c = cohort_keys(gen, m, safe, epochs=epochs, n=n, perms=perms)
        pc = aggregation.cohort_gather(params, safe32)
        post = train(pc, x[safe], y[safe], perms_c, *args)
        return mix(params, post, idx, mask, *args)

    return body


def fedavg_masked_mix(params, updated, idx, mask, n):
    """Masked Eq. 1: the n-weighted mean of the real cohort uploads
    (``updated``, (c, d)), broadcast to every row of the ``params`` slab.

    ``n`` is the full (m,) dataset sizes: the pad sentinels are clamped
    against it. An all-masked cohort keeps the previous model instead of
    broadcasting the degenerate zero mix. This is the one sanctioned
    full-state write of the cohort engine; it returns a new tensor.
    """
    safe = aggregation.safe_gather_index(idx, n.shape[0]).long()
    w = aggregation.masked_fedavg_weights(n[safe], mask)
    mixed = aggregation.user_centric(updated, w)  # (1, d)
    return torch.where(torch.any(mask), mixed.expand_as(params), params)
