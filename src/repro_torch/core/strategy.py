"""Strategy protocol and the paper's hyperparameters.

A strategy owns three callables:

  * ``init(gen, data) -> state`` — the initial state, including the
    paper's collaboration round;
  * ``round(state, data, gen, cohort=None, *, perms=None) -> (state,
    metrics)`` — one communication round (local training + PS mix).
    ``perms`` injects the (m, epochs, ≥ steps·B) batch orders instead of
    drawing them from ``gen``. Only full participation (``cohort=None``)
    is ported; a cohort raises (ROADMAP A10);
  * ``eval_params(state) -> stacked params`` — the per-client models to
    evaluate.
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


def register(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Paper §V-A hyperparameters, as far as this slice of the port runs.

    ``chunk_size`` bounds peak client-axis memory: local SGD and the
    special round train sequential chunks of that many clients (see
    :func:`repro_torch.federated.client.make_federated_local_sgd`); ``None``
    trains all clients at once. The reference's engine knobs (mesh,
    shard_state, w_refresh, async_buffer, faults, robust, transport,
    topology, selection) come with later slices; naming one here raises
    ``TypeError`` at construction.
    """
    lr: float = 0.1
    momentum: float = 0.9
    epochs: int = 1
    batch_size: int = 50
    chunk_size: int | None = None
