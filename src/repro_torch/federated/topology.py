"""Static client→edge topology for the two-tier hierarchical engine.

A :class:`Topology` assigns every client to an edge aggregator
(``edge_of[i]``): each edge runs the tier-1 masked mix over its own cohort
members, and only the per-edge aggregates cross the edge↔PS backhaul for
the tier-2 combine. ``FedConfig.topology = None`` keeps the flat path bit
for bit.

Fixed shapes, the cohort's sentinel trick one level up: every edge is
padded to ``s = slots_per_edge(c)`` slots, and :func:`edge_partition`
splits a padded cohort's (c,) slot arrays into (E, s) per-edge ones on the
device (a stable argsort by edge id, so each edge's real slots form a
prefix in the cohort's order). Pad slots carry the client sentinel m and
the cohort-slot sentinel c; the writes that the reference drops land in a
spare slot that is sliced off.

The tiered mixes factorize the flat linear rules: tier-1 aggregates are
normalized per edge with their weight mass, tier 2 reweights by mass, so
the result equals the flat mix up to float association. Strategies whose
PS rule does not factorize over per-edge partial sums refuse the knob at
construction (:func:`unsupported`), and :func:`check_composition` refuses
the knob beside ``shard_state`` or ``async_buffer``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static client→edge assignment for two-tier rounds.

    edge_of: length-m tuple, ``edge_of[i]`` the edge serving client i (in
      ``[0, num_edges)``); num_edges: E (an edge may hold no cohort member
      in a round, or no client at all).
    """

    edge_of: tuple
    num_edges: int

    def __post_init__(self):
        edge_of = tuple(int(e) for e in self.edge_of)
        object.__setattr__(self, "edge_of", edge_of)
        if self.num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {self.num_edges}")
        if not edge_of:
            raise ValueError("edge_of must assign at least one client")
        bad = [e for e in edge_of if not 0 <= e < self.num_edges]
        if bad:
            raise ValueError(f"edge ids must lie in [0, {self.num_edges}), got {bad[:4]}")

    @property
    def num_clients(self) -> int:
        return len(self.edge_of)

    @classmethod
    def from_labels(cls, labels) -> "Topology":
        """Build from any per-client label array (e.g. cluster labels)."""
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy()
        lab = np.asarray(labels, dtype=np.int64).reshape(-1)
        return cls(tuple(lab.tolist()), int(lab.max()) + 1)

    @classmethod
    def contiguous(cls, m: int, num_edges: int) -> "Topology":
        """m clients in ``num_edges`` contiguous, near-equal blocks."""
        return cls(tuple(np.arange(m) * num_edges // max(m, 1)), num_edges)

    def slots_per_edge(self, cohort_slots: int) -> int:
        """Per-edge slot count s for a c-slot cohort: an edge holds at most
        min(its population, c) of a cohort's distinct members."""
        pop = np.bincount(np.asarray(self.edge_of), minlength=self.num_edges)
        return int(min(cohort_slots, pop.max()))

    def edge_array(self, device=None):
        """The assignment as an (m,) int32 tensor on ``device``."""
        return torch.tensor(self.edge_of, dtype=torch.int32, device=device)

    def check_clients(self, m: int, strategy: str) -> None:
        if self.num_clients != m:
            raise ValueError(f"{strategy}: topology assigns {self.num_clients} clients "
                             f"but the dataset has {m}")


def edge_ids(edge_arr, num_edges: int, idx, mask):
    """Per-cohort-slot edge id; pads get the sentinel edge ``num_edges``."""
    m = edge_arr.shape[0]
    safe = torch.clamp_max(idx.long(), m - 1)
    return torch.where(mask.bool(), edge_arr[safe].long(),
                       torch.full_like(safe, num_edges))


def edge_onehot(edge_arr, num_edges: int, idx, mask):
    """(c, E) f32 edge membership of each cohort slot (pads all-zero)."""
    g = edge_ids(edge_arr, num_edges, idx, mask)
    return (g[:, None] == torch.arange(num_edges, device=g.device)[None, :]).to(torch.float32)


def edge_partition(edge_arr, num_edges: int, slots: int, idx, mask):
    """Split a padded cohort into (E, s) per-edge slot arrays, on the
    device with no sync: ``eidx`` int32 client ids (sentinel m on pads),
    ``emask`` bool (a prefix per edge), ``eslot`` int32 the cohort slot each
    per-edge slot came from (sentinel c on pads). The stable sort keeps the
    cohort's slot order within an edge; pads sort to the sentinel edge,
    whose destinations lie past E·s and land in spare slots."""
    c = idx.shape[0]
    m = edge_arr.shape[0]
    g = edge_ids(edge_arr, num_edges, idx, mask)
    order = torch.argsort(g, stable=True)
    gs = g[order]
    pos = torch.arange(c, device=g.device) - torch.searchsorted(gs, gs, side="left")
    dest = gs * slots + pos
    flat = num_edges * slots
    spare = flat + c  # every pad's destination lies below this

    def place(fill, values, dtype):
        out = torch.full((spare,), fill, dtype=dtype, device=g.device)
        return out.index_copy_(0, dest, values.to(dtype))[:flat].view(num_edges, slots)

    return (place(m, idx[order], torch.int32),
            place(False, mask.bool()[order], torch.bool),
            place(c, order, torch.int32))


def check_composition(topology, strategy: str, *, shard_state=False, async_buffer=None):
    """Construction-time guards of the knob combinations that cannot tier;
    returns ``topology`` (possibly None) when the combination is legal."""
    if topology is None:
        return None
    if not isinstance(topology, Topology):
        raise TypeError(f"FedConfig.topology must be a federated.topology.Topology, "
                        f"got {type(topology).__name__}")
    if shard_state:
        raise NotImplementedError(
            f"FedConfig.topology does not compose with shard_state in {strategy}: the "
            "row-sharded gather/scatter owns the client axis per device while the edge "
            "partition owns it per edge — a joint edge×shard layout is future work (drop one "
            "knob)")
    if async_buffer is not None:
        raise NotImplementedError(
            f"FedConfig.topology does not compose with async_buffer in {strategy}: a flush "
            "applies arrivals banked across rounds, so no single round's edge partition "
            "covers the flushed batch — tiering the pending buffer is future work (drop "
            "one knob)")
    return topology


def unsupported(topology, strategy: str, why: str) -> None:
    """Raise at construction when a strategy cannot tier its PS mix."""
    if topology is not None:
        raise NotImplementedError(
            f"FedConfig.topology is not supported by {strategy}: {why} (supported: the "
            "fedavg family and clustered ucfl — strategies whose PS mix factorizes over "
            "per-edge partial aggregates)")
