"""Buffered-async server aggregation (FedBuff-style) for cohort rounds.

The barrier engine waits for all c uploads of a cohort before it mixes.
The buffered-async server instead keeps a pending buffer and *flushes*
(applies a staleness-weighted aggregation and bumps its model version) as
soon as ``flush_k`` uploads have accumulated, so the §V-D round time is
set by the K-th arrival, not the c-th
(:func:`repro_torch.core.comm_model.async_round_time`).

Buffer state (strategy state ``abuf``, tensors on the slab's device):

  * ``upd``   — (B + 1, W) f32 pending upload rows: models for the
    user-centric rules, model *deltas* for the FedAvg family.
    ``B = flush_k − 1 + slots``, with ``slots`` the cohort's slot count
    (rounded up to a multiple of the shard count when ``upd`` is
    row-sharded, ``FedConfig.shard_state``; then each rank holds its
    (B/s, W) block of ``upd`` and a spare row, and the metadata whole):
    a flush clears the buffer whenever it holds ≥ flush_k uploads at round
    end, so at most ``flush_k − 1`` pend across rounds and one round adds
    at most ``slots``. Row B is a spare that the deposits of pad slots
    write and nothing reads (the reference drops those writes); the
    buffer proper is ``upd[:B]`` (:func:`rows`).
  * ``idx``   — (B,) int32 uploading client a slot; the sentinel m marks
    an empty slot. A slot is valid when ``idx < m``; a flush resets only
    ``idx`` and ``count``, so the ``upd``/``ver`` of cleared slots are
    stale values that nothing reads.
  * ``ver``   — (B,) int32 server version of the base model a slot's
    upload was computed against; at a flush its staleness is ``τ =
    version − ver`` and its weight ``(1 + τ)^−α``.
  * ``count`` — () int32 pending uploads; ``version`` — () int32 flush
    counter; ``last_sync`` — (m,) int32 the version at which each client's
    row was last rewritten by a flush (the base of its next upload under
    the user-centric rules).

A client with an upload already pending overwrites it in place (latest
wins), so the valid indices stay distinct; they are in arrival order, not
sorted, which the fused mix-scatter takes as they are.

W is the strategy's uplink wire slab width (``schema.width_aligned
("uplink")``), or ``ops.aligned_dim(dim)``; deposits zero-pad narrower
rows. The async downlink stays raw f32.

No host sync: a flush is a device predicate (``count >= flush_k``), never
read back. The strategies fold it into the work: the mix-scatter's mask is
``valid & flush``, the FedAvg add ``where(flush, …)``, and
:func:`flush_reset` takes the predicate, so a deposit-only round leaves
``params`` bit-identical. Every scatter that the reference runs with
``mode="drop"`` writes a spare row or slot here that is sliced off.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Buffered-async server policy.

    flush_k: the server applies the buffered uploads as soon as at least
      ``flush_k`` are pending at the end of a round (the whole buffer).
    alpha: staleness-discount exponent: an upload ``τ`` versions old
      weighs ``(1 + τ)^−α`` before the rule's row renormalization; 0
      disables the discount.
    """

    flush_k: int = 2
    alpha: float = 0.5

    def __post_init__(self):
        if int(self.flush_k) < 1:
            raise ValueError(f"flush_k must be >= 1, got {self.flush_k}")
        if not 0.0 <= float(self.alpha):
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")

    def capacity(self, slots: int) -> int:
        """Buffer slot count for a policy with ``slots`` cohort slots."""
        return int(self.flush_k) - 1 + int(slots)


def init_buffer(cfg: AsyncConfig, m: int, slots: int, dim: int, *, shards: int = 1,
                schema=None, device=None) -> dict:
    """An empty buffer (module docstring) on ``device``: rows at the
    aligned width of ``dim``, or at ``schema``'s uplink wire-slab width.
    ``shards`` pads the slot count B up to a multiple, so that a
    row-sharded ``upd`` partitions evenly; the extra slots stay empty
    sentinels (no deposit reaches them)."""
    b = cfg.capacity(slots)
    b = -(-b // int(shards)) * int(shards)
    width = schema.width_aligned("uplink") if schema is not None else ops.aligned_dim(dim)
    return {
        "upd": torch.zeros((b + 1, width), dtype=torch.float32, device=device),
        "idx": torch.full((b,), m, dtype=torch.int32, device=device),
        "ver": torch.zeros((b,), dtype=torch.int32, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "version": torch.zeros((), dtype=torch.int32, device=device),
        "last_sync": torch.zeros((m,), dtype=torch.int32, device=device),
    }


def rows(buf):
    """The (B, W) buffer rows, without the spare (a contiguous view)."""
    return buf["upd"][: buf["idx"].shape[0]]


def valid_mask(buf, m: int):
    """(B,) bool — slots holding a pending upload (sentinel m = empty)."""
    return buf["idx"] < m


def _set(values, dest, new, spare):
    """``values[dest[i]] = new[i]`` with ``dest[i] == len(values)`` dropped:
    written into a spare element past the end, then sliced off."""
    n = values.shape[0]
    ext = torch.cat([values, values.new_full((1,), spare)])
    return ext.index_copy_(0, dest, new.to(values.dtype))[:n]


def deposit(buf, rows_c, idx, mask, base_ver, m: int, *, scatter=None):
    """Land one cohort's (c, ·) uploads ``rows_c`` in the buffer.

    ``idx``/``mask`` are the cohort's (final) slot arrays, ``base_ver`` the
    (c,) version each upload was computed against. Real slots whose client
    has an upload pending overwrite it in place; the rest append at
    ``count`` onward; pad and demoted slots deposit nothing (they write the
    spare row). ``last_sync`` is left alone: only a flush moves it.
    On the card ``upd`` is written in place; on the CPU it is a copy.
    ``scatter(upd, dest, rows) -> upd`` writes the rows of a row-sharded
    ``upd`` (``StateOps.buffer_scatter``), with ``dest`` B, the spare,
    where nothing lands.
    """
    bcap = buf["idx"].shape[0]
    live = mask.bool()
    pending = valid_mask(buf, m)
    # (c, B) membership of each incoming client among the pending slots;
    # the pending ids are distinct, so a row has at most one hit
    dup = (idx[:, None] == buf["idx"][None, :]) & live[:, None] & pending[None, :]
    has_dup = torch.any(dup, dim=1)
    dup_pos = torch.argmax(dup.to(torch.int32), dim=1)  # the first hit
    fresh = live & ~has_dup
    append_pos = buf["count"] + torch.cumsum(fresh.to(torch.int32), dim=0) - 1
    dest = torch.where(live, torch.where(has_dup, dup_pos, append_pos),
                       torch.full_like(dup_pos, bcap))
    width = buf["upd"].shape[1]
    if rows_c.shape[1] < width:
        rows_c = torch.nn.functional.pad(rows_c, (0, width - rows_c.shape[1]))
    if scatter is not None:
        upd = scatter(buf["upd"], dest, rows_c)
    else:
        upd = buf["upd"] if buf["upd"].is_cuda else buf["upd"].clone()
        upd.index_copy_(0, dest, rows_c.to(upd.dtype))
    return dict(buf, upd=upd,
                idx=_set(buf["idx"], dest, idx, m),
                ver=_set(buf["ver"], dest, base_ver, 0),
                count=buf["count"] + torch.sum(fresh.to(torch.int32)).to(torch.int32))


def staleness(buf):
    """(B,) int32 per-slot staleness ``τ = version − ver`` (≥ 0)."""
    return torch.clamp_min(buf["version"] - buf["ver"], 0)


def staleness_weights(buf, m: int, alpha: float):
    """(B,) f32 flush weights ``valid · (1 + τ)^−α``; empty slots weigh
    exactly 0, and τ = 0 weighs exactly 1."""
    w = torch.pow(1.0 + staleness(buf).to(torch.float32), -float(alpha))
    return torch.where(valid_mask(buf, m), w, torch.zeros_like(w))


def flush_reset(buf, m: int, flush=None):
    """The buffer after a flush: version bumped, every slot cleared, and
    ``last_sync`` of the applied clients raised to the new version. Only
    ``idx`` and ``count`` are reset; the payloads of cleared slots stay.
    ``flush`` (a device bool) predicates the reset: where it is False the
    buffer comes back as it was."""
    version = buf["version"] + 1
    synced = _set(buf["last_sync"], buf["idx"].long(),
                  version.expand(buf["idx"].shape), 0)
    reset = dict(idx=torch.full_like(buf["idx"], m), count=torch.zeros_like(buf["count"]),
                 version=version, last_sync=synced)
    if flush is not None:
        reset = {k: torch.where(flush, v, buf[k]) for k, v in reset.items()}
    return dict(buf, **reset)


def flush_metrics(flushed, applied, tau, weights, fill):
    """Device-scalar round metrics of every async strategy body.

    flushed () bool — did this round apply the buffer; applied () int32 —
    uploads applied; tau (B,) int32 staleness at flush time; weights (B,)
    the flush weights (0 on empty slots); fill () int32 the occupancy
    after the round.
    """
    live = weights > 0
    wsum = torch.clamp_min(torch.sum(live.to(torch.float32)), 1.0)
    held = torch.where(live, tau, torch.zeros_like(tau))
    zero = torch.zeros_like(applied)
    return {
        "flushed": flushed.to(torch.int32),
        "applied": torch.where(flushed, applied, zero),
        "buffer_fill": fill,
        "tau_max": torch.where(flushed, torch.max(held), torch.zeros_like(held[0])),
        "tau_mean": torch.where(flushed, torch.sum(held.to(torch.float32)) / wsum,
                                torch.zeros_like(wsum)),
    }
