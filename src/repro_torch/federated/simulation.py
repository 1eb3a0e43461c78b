"""Federated simulation engine: rounds loop + per-round evaluation.

Partial participation: ``run(..., participation=ParticipationConfig(...))``
draws a fixed-shape padded cohort per round
(:func:`repro_torch.federated.participation.sample_cohort`, its own numpy
seed stream) and passes it to ``strategy.round(state, data, gen,
cohort)``. A round whose cohort is all-offline is skipped: the strategy's
``skip_round`` hook runs when it has one, and the round's metrics are
``{"streams": 0, "cohort_size": 0, "skipped": True}``.

In place: on the card the cohort round writes the cohort rows of the
params slab in place, the port's analogue of the reference's buffer
donation; :func:`clone_state` (the reference's name:
:func:`donation_safe_copy`) copies a state, and the warm-up runs on such a
copy.

Client mesh: a strategy built with ``FedConfig(mesh=...)`` runs on every
rank of the process group with the same seed (SPMD); the loop itself is
the same on each. ``eval_mesh`` shards the evaluation's client axis, and
a row-sharded state (``FedConfig.shard_state``) has each rank evaluate
and finite-check its own block of the clients; the (m,) results are
all-gathered. ``verbose`` prints on rank 0 only.

Randomness: ``run`` takes an integer seed and spawns three independent
``torch.Generator`` streams on the device from it (``numpy``'s
``SeedSequence``): one for ``strategy.init`` (K-means++ seeds, Alg. 2),
one for the warm-up round and one for the timed rounds, so the warm-up
never shifts the rounds' batch orders.

Selection: ``run(selection=SelectionConfig(...))`` (``FedConfig.selection``)
switches the participation policy to the ``pareto`` sampler
(:func:`repro_torch.federated.participation.with_selection`); the strategy
never draws cohorts itself.

Timing: the special round (``strategy.init``) is timed into
``History.init_s``. With ``warmup`` (the default) ``strategy.round`` is
then run once on a clone of the state (result discarded; under partial
participation with round 1's cohort, or with a synthetic one-member
cohort of the same slot count when round 1 is all-offline) before the
round timer starts, so ``History.wall_s`` measures steady-state rounds,
not first-call costs such as the kernel build and cuDNN's algorithm
search. The warm-up draws from its own generator and leaves the state as
it was (a buffered strategy's lazily created buffer included), so
``warmup=False`` gives the same trajectory. The evaluation passes are
timed separately into ``History.eval_s`` and excluded from ``wall_s``;
``eval_chunk`` bounds their client axis (``client.evaluate``'s
``batch``). Every interval ends in a device synchronize.

Evaluation schedule: as the reference's ``run``, the finite check and the
evaluation run after round ``rnd`` only when ``rnd % eval_every == 0`` or
``rnd == rounds``; ``History.rounds`` lists the rounds evaluated, and
``History.paired_best`` takes its argmax over those alone. The
reference's Tables 1/2 pass ``eval_every = max(rounds // 4, 1)`` to
``run_trials``. The finite check stands down by default when the strategy
injects faults (``Strategy.injects_faults``): its finite guard absorbs
the poisoned uploads. ``verbose`` prints a line an evaluated round, the
reference's: the accuracies, the round's cohort size, and the refresh's
``staleness_max`` and ``staleness_mean`` where the round reports them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pytree
from repro_torch.device import resolve_device
from repro_torch.federated import mesh as mesh_lib
from repro_torch.federated import participation as part
from repro_torch.federated.client import evaluate


@dataclasses.dataclass
class History:
    """Per-run eval trajectory + timing split.

    ``wall_s`` is the steady-state ROUND time only; ``eval_s`` the
    accumulated evaluation time; ``init_s`` the special round's.
    """

    strategy: str
    rounds: List[int]
    avg_acc: List[float]
    worst_acc: List[float]
    metrics: List[Dict[str, Any]]
    wall_s: float = 0.0
    eval_s: float = 0.0
    init_s: float = 0.0
    state: Any = dataclasses.field(default=None, repr=False)  # after the last round

    @property
    def final_avg(self):
        return self.avg_acc[-1]

    @property
    def final_worst(self):
        return self.worst_acc[-1]

    @property
    def best_avg(self):
        return max(self.avg_acc)

    @property
    def paired_best(self):
        """(avg, worst) evaluated at the argmax-average round.

        Tables 1/2 pair average and worst-user accuracy of ONE model;
        taking max() of each list independently would mix two rounds.
        """
        i = int(np.argmax(self.avg_acc))
        return self.avg_acc[i], self.worst_acc[i]


def clone_state(state):
    """Copy every tensor of a state dict, and of the dicts in it (the
    refresh buffers, the async buffer). The cohort round writes the params
    slab (and those buffers) in place, so a caller that keeps the
    pre-round state (the warm-up, an A/B comparison) runs the round on this
    copy."""
    return {k: v.clone() if isinstance(v, torch.Tensor)
            else clone_state(v) if isinstance(v, dict) else v
            for k, v in state.items()}


def donation_safe_copy(state):
    """The reference's name for :func:`clone_state`: a copy of the state
    that a round may write in place while the original stays as it was."""
    return clone_state(state)


def _client_rows_finite(stacked: dict) -> torch.Tensor:
    """(m,) bool: every leaf of client i's eval params is finite."""
    rows = [torch.isfinite(x.float()).reshape(x.shape[0], -1).all(dim=1)
            for x in pytree.leaves(stacked)]
    return torch.stack(rows).all(dim=0)


def _check_finite_state(strategy, state, rnd):
    """Fail fast on non-finite models instead of training on NaNs. A
    row-sharded state checks its rank's block and all-gathers the rows."""
    finite = _client_rows_finite(strategy.eval_params(state))
    rows_mesh = mesh_lib.row_mesh(state)
    if rows_mesh is not None:
        finite = mesh_lib.all_gather_rows(finite, rows_mesh)
    finite = finite.cpu().numpy()
    if not finite.all():
        bad = np.nonzero(~finite)[0].tolist()
        raise RuntimeError(
            f"non-finite model state after round {rnd} (strategy "
            f"{strategy.name!r}, client rows {bad})")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generators(seed, device):
    seqs = np.random.SeedSequence(seed).spawn(3)
    gens = []
    for s in seqs:
        g = torch.Generator(device=device)
        g.manual_seed(int(s.generate_state(1, np.uint64)[0] >> np.uint64(2)))
        gens.append(g)
    return gens


def _warmup_cohort(participation, m, n):
    """Round 1's cohort; when round 1 is all-offline, a synthetic
    one-member cohort of the same slot count, so the warm-up still runs
    the cohort round."""
    cohort = part.sample_cohort(participation, 1, m, n)
    if cohort is not None and len(cohort) == 0:
        idx = np.full(cohort.num_slots, m, np.int32)
        idx[0] = 0
        mask = np.zeros(cohort.num_slots, bool)
        mask[0] = True
        cohort = part.Cohort(indices=idx, mask=mask)
    return cohort


def _round_line(name, rnd, accs, metrics, m):
    stale = ("" if "staleness_max" not in metrics else
             f" stale_max={int(metrics['staleness_max'])}"
             f" stale_mean={float(metrics['staleness_mean']):.1f}")
    return (f"[{name}] round {rnd:4d} avg={accs.mean():.4f} worst={accs.min():.4f} "
            f"cohort={metrics.get('cohort_size', m)}{stale}")


def _check_selection(selection):
    if selection is not None and not isinstance(selection, part.SelectionConfig):
        raise TypeError(f"selection must be a SelectionConfig or None, "
                        f"got {type(selection).__name__}")


def run(strategy, apply_stacked, data, seed: int, *, rounds: int, eval_every: int = 1,
        participation: part.ParticipationConfig | None = None, warmup: bool = True,
        eval_chunk: int | None = None, eval_mesh=None, device=None,
        check_finite: bool | None = None, verbose: bool = False, selection=None) -> History:
    """Run ``rounds`` rounds; after round ``rnd`` a finite check of the
    clients' models and an evaluation run when ``rnd % eval_every == 0``
    or ``rnd == rounds`` (the reference's rule). ``check_finite`` None
    means on unless the strategy injects faults.

    ``participation`` None (or a full policy) runs the dense
    full-participation round; otherwise each round's cohort is
    ``sample_cohort(participation, rnd, m, n)``; ``selection`` (a
    :class:`~repro_torch.federated.participation.SelectionConfig`) turns
    the policy into the ``pareto`` sampler. ``warmup`` runs one discarded
    round before the timer; ``eval_chunk`` bounds the evaluation's client
    axis and ``eval_mesh`` (a ``FedConfig.mesh`` knob, typically the
    strategy's) shards it across the ranks; a row-sharded state is
    evaluated on its own mesh. ``data`` must already live on ``device``
    (CUDA unless told otherwise).
    """
    if eval_every < 1:
        raise ValueError(f"eval_every must be at least 1, got {eval_every}")
    _check_selection(selection)
    participation = part.with_selection(participation, selection)
    dev = resolve_device(device)
    if data.x.device.type != dev.type:
        raise ValueError(f"data lives on {data.x.device}, run on {dev}")
    m = data.num_clients
    n_host = data.n.cpu().numpy()  # for the weighted sampler, copied once
    if check_finite is None:
        check_finite = not strategy.injects_faults
    init_gen, warm_gen, round_gen = _generators(seed, dev)
    eval_mesh = mesh_lib.resolve(eval_mesh)
    rank0 = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    hist = History(strategy.name, [], [], [], [])

    _sync(dev)
    t = time.perf_counter()
    state = strategy.init(init_gen, data)
    _sync(dev)
    hist.init_s = time.perf_counter() - t

    if warmup:  # first-call costs stay outside the timed region
        wstate, _ = strategy.round(clone_state(state), data, warm_gen,
                                   _warmup_cohort(participation, m, n_host))
        _sync(dev)
        del wstate

    t0 = time.perf_counter()

    def do_eval(rnd, metrics):
        _sync(dev)  # the round's queued work belongs to the round time
        te = time.perf_counter()
        if check_finite:
            _check_finite_state(strategy, state, rnd)
        rows_mesh = mesh_lib.row_mesh(state)
        accs = evaluate(apply_stacked, strategy.eval_params(state), data.x_test,
                        data.y_test, batch=eval_chunk,
                        mesh=eval_mesh if rows_mesh is None else rows_mesh).cpu().numpy()
        if verbose and rank0:
            print(_round_line(strategy.name, rnd, accs, metrics, m), flush=True)
        hist.eval_s += time.perf_counter() - te
        hist.rounds.append(rnd)
        hist.avg_acc.append(float(accs.mean()))
        hist.worst_acc.append(float(accs.min()))
        hist.metrics.append(metrics)

    for rnd in range(1, rounds + 1):
        cohort = part.sample_cohort(participation, rnd, m, n_host)
        if cohort is not None and len(cohort) == 0:
            # nobody is online: no training and no mix this round
            if strategy.skip_round is not None:
                state = strategy.skip_round(state)
            metrics = {"streams": 0, "cohort_size": 0, "skipped": True}
        else:
            state, metrics = strategy.round(state, data, round_gen, cohort)
        if rnd % eval_every == 0 or rnd == rounds:
            do_eval(rnd, metrics)
    _sync(dev)
    hist.wall_s = time.perf_counter() - t0 - hist.eval_s
    hist.state = state
    return hist


def run_trials(make_strategy, apply_stacked, data_fn, *, trials: int, rounds: int,
               seed: int = 0, eval_every: int = 1, participation=None, selection=None,
               device=None):
    """Average over independent trials (the paper reports 5-trial means).

    Trial ``t`` draws its data with ``data_fn(s)`` and runs
    ``make_strategy(t)`` with ``run(..., seed=s)``, where ``s = seed +
    1000 * t`` (the reference's per-trial key); ``data_fn`` returns data on
    ``device``. ``run`` spawns its generators from ``s`` through a
    ``SeedSequence``, so they are independent of a synthesizer that seeds
    a numpy generator with ``s`` itself. The reported (avg, worst) pair of
    a trial is its ``History.paired_best``: one model, the argmax-average
    evaluated round, as Tables 1/2 pair them. ``selection`` goes to every
    trial's ``run``.
    """
    _check_selection(selection)
    avgs, worsts, hists = [], [], []
    for trial in range(trials):
        s = seed + 1000 * trial
        h = run(make_strategy(trial), apply_stacked, data_fn(s), s, rounds=rounds,
                eval_every=eval_every, participation=participation, device=device,
                selection=selection)
        avg, worst = h.paired_best
        avgs.append(avg)
        worsts.append(worst)
        hists.append(h)
    return {
        "avg_mean": float(np.mean(avgs)),
        "avg_std": float(np.std(avgs)),
        "worst_mean": float(np.mean(worsts)),
        "worst_std": float(np.std(worsts)),
        "histories": hists,
    }
