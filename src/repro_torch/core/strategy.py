"""Strategy protocol and the paper's hyperparameters.

A strategy owns these callables:

  * ``init(gen, data) -> state`` — the initial state, including the
    paper's collaboration round;
  * ``round(state, data, gen, cohort=None, *, perms=None) -> (state,
    metrics)`` — one communication round (local training + PS mix).
    ``cohort`` is None (full participation, the dense path), a
    :class:`~repro_torch.federated.participation.Cohort` or a plain index
    array (the masked cohort path, which writes the cohort rows of the
    params slab in place on the card). ``perms`` injects the (m, epochs,
    ≥ steps·B) batch orders of all m clients instead of drawing them from
    ``gen``; a cohort round takes its slots' rows itself;
  * ``eval_params(state) -> stacked params`` — the per-client models to
    evaluate;
  * ``skip_round(state) -> state`` (optional) — what a round that nobody
    attends (an all-offline availability cohort) does to the state; the
    simulation loop calls it instead of ``round``.

``injects_faults`` is True when the strategy was built with
``FedConfig.faults``: the simulation loop's finite check then stands down
(the upload stage's finite guard absorbs the injected NaN/Inf uploads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

REGISTRY: Dict[str, Callable[..., "Strategy"]] = {}


@dataclasses.dataclass
class Strategy:
    name: str
    init: Callable[..., Any]
    round: Callable[..., Any]
    eval_params: Callable[[Any], Any]
    # the downlink, for the comm model: "broadcast", "groupcast",
    # "unicast" or "client_mixing", and its stream count where fixed
    comm_scheme: str = "broadcast"
    num_streams: int | None = None
    skip_round: Callable[[Any], Any] | None = None
    injects_faults: bool = False
    # the declared wire layout, a
    # :class:`repro_torch.federated.transport.WireSchema`: the transport
    # stages and the comm model's byte pricing
    # (``comm_model.wire_bytes``) read it
    wire_schema: Any = None


def register(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Paper §V-A hyperparameters and the engine knobs.

    ``chunk_size`` bounds peak client-axis memory: local SGD and the
    special round train sequential chunks of that many clients (see
    :func:`repro_torch.federated.client.make_federated_local_sgd`); ``None``
    trains all clients at once.

    ``transport`` (a :class:`repro_torch.federated.transport.TransportConfig`,
    or ``None`` = off) quantizes the wire of cohort rounds: each strategy's
    ``delta`` streams travel int8 or fp8 with error feedback, per stream of
    its ``wire_schema`` (the client's on the uplink, the server's on a
    delta-coded downlink); the state then holds the EF slabs ``ef`` and,
    where the downlink is delta-coded, ``ef_dl``. Anything but a
    ``TransportConfig`` raises ``TypeError`` when a strategy is built; a
    dense round with it raises ``ValueError``. ``None`` keeps every
    trajectory bit-identical.

    ``w_refresh`` (a :class:`repro_torch.core.similarity.RefreshConfig`, or
    ``None`` = off) opts the W-owning strategies (``ucfl``, its clustered
    variant, ``ucfl_parallel``) into the streaming W refresh: every cohort
    round folds the cohort's uploads into running Δ̂/σ̂² buffers and
    recomputes W, with per-client staleness in the round metrics. The
    dense round never refreshes; strategies without a W ignore the knob.

    ``faults`` (a :class:`repro_torch.federated.faults.FaultConfig`) and
    ``robust`` (a :class:`repro_torch.core.aggregation.RobustConfig`), each
    ``None`` = off, insert the upload stage into every cohort round, after
    the wire stage and before the mix: fault injection (Byzantine uploads,
    drops), the finite guard, then the robust rule. Demoted slots keep
    their previous rows. A dense round with either raises ``ValueError``;
    ``ucfl_parallel`` raises ``NotImplementedError`` at construction.

    ``async_buffer`` (a :class:`repro_torch.federated.async_buffer.AsyncConfig`,
    or ``None`` = off) opts cohort rounds into the buffered-async
    FedBuff-style server: uploads land in a fixed-shape pending buffer and
    the PS applies them, staleness-discounted by ``(1+τ)^{-α}``, once
    ``flush_k`` have accumulated, instead of barrier-mixing every round.
    Supported by the strategies whose PS step is the masked row aggregation
    (ucfl full/clustered and the FedAvg family); the rest raise at
    construction. Requires cohort rounds (a participation config): the
    dense ``cohort=None`` path is the bulk-synchronous barrier by
    definition. ``None`` keeps every existing trajectory bit-identical.

    ``topology`` (a :class:`repro_torch.federated.topology.Topology`, or
    ``None`` = off) opts cohort rounds into the two-tier hierarchical
    engine: clients are statically assigned to edge aggregators, the
    tier-1 masked mix runs per edge over fixed-shape padded per-edge slots,
    and only the ``(E, ·)`` edge-aggregate slab crosses the edge↔PS
    backhaul for the mass-weighted tier-2 combine, an exact factorization
    of the flat linear rules up to float association. Supported where the
    PS rule is linear in the uploads (the FedAvg family and clustered
    ucfl, composing with ``transport``, ``faults``/``robust`` and
    ``w_refresh``); per-client unicast mixes (ucfl full, fedfomo, ...) and
    ``async_buffer`` raise ``NotImplementedError`` at construction, and a
    value that is not a ``Topology`` raises ``TypeError``. Requires cohort
    rounds. ``None`` keeps every existing trajectory bit-identical.

    ``selection`` (a :class:`repro_torch.federated.participation.SelectionConfig`,
    or ``None`` = off) declares Pareto-biased cohort selection: per-round
    sampling mass biased by compute speed, link quality, a battery or
    diurnal availability trace and data value, with a deterministic
    round-robin fairness lane bounding every positive-mass client's
    selection window. Callers thread it into the sampler with
    :func:`repro_torch.federated.participation.with_selection` (the
    strategy never draws cohorts itself). ``None`` keeps the configured
    sampler untouched.

    ``mesh`` shards the cohort/client axis across the ranks of a
    ``torch.distributed`` process group (see
    :mod:`repro_torch.federated.mesh`): a
    :class:`~repro_torch.federated.mesh.ClientMesh`, an int shard count, or
    ``"auto"`` for every rank of the default group; 1 needs no group. Every
    rank runs the same program on the same seeds; local SGD runs on the
    rank's block of the cohort slots (``chunk_size`` then chunks *within*
    it) and the cohort dispatcher pads slot counts to a shard multiple
    with sentinel slots, so every rank trains the same count. The trained
    rows are all-gathered, and the mix and the fused scatter then run on
    every rank's copy of the state. Results match ``mesh=None`` within f32
    round-off (the local batch shape changes the products' algorithms);
    ``mesh=1`` is bit for bit ``mesh=None``.

    ``shard_state`` row-shards the (m, ·) stacked server state across the
    ``mesh`` (see the row-sharded section of
    :mod:`repro_torch.federated.mesh`): rank k holds rows [k·m/s,
    (k+1)·m/s) of every stacked slab, the cohort gather is a (c, d) SUM
    all-reduce of the owners' rows, the scatter and the mix-scatter write
    only the owner's block, and the only model-sized collectives are
    O(c·d). Requires a mesh with ``m % num_shards == 0`` and cohort rounds;
    the replicated layout and ``mesh=None`` stay bit-exact. Composes with
    ``w_refresh``, ``transport``, ``faults``/``robust`` and
    ``async_buffer``; ``topology`` and ``ucfl_parallel`` raise
    ``NotImplementedError`` at construction.

    Off (``None``), each knob keeps every trajectory bit-identical.
    """
    lr: float = 0.1
    momentum: float = 0.9
    epochs: int = 1
    batch_size: int = 50
    chunk_size: int | None = None
    w_refresh: Any = None
    async_buffer: Any = None
    faults: Any = None
    robust: Any = None
    transport: Any = None
    topology: Any = None
    selection: Any = None
    mesh: Any = None
    shard_state: bool = False
