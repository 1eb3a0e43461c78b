"""The per-rank programs of the port's mesh tests, run in processes that
``repro_torch.federated.mesh.spawn`` starts (gloo on the CPU, ``file://``
init). Each rank rebuilds the small task from its numpy seed, so this
module imports no jax: a spawned rank pays only for torch.

A *run* is a dict naming a strategy, its ``FedConfig`` fields, the layout
(``shard``), and the cohorts and batch orders of its rounds; every rank
runs it the same way (SPMD) and returns its state slabs (its block when
row-sharded), its metrics, the per-client accuracies and the rows it
holds.
"""
from __future__ import annotations

import contextlib
import io
import time

import numpy as np
import torch

from parity_arrays import small_arrays
from repro_torch import interop
from repro_torch.core import REGISTRY, FedConfig
from repro_torch.core.aggregation import RobustConfig
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import async_buffer, client, faults, mesh, participation, simulation
from repro_torch.federated.transport import TransportConfig
from repro_torch.models import lenet

SLABS = ("params", "personal", "c_i", "c", "ef", "ef_dl")


def task(seed, m):
    """(port data, port params0) of the small task with m clients, on the CPU."""
    arrays, params = small_arrays(seed, m)
    return (interop.data_from_numpy(*arrays, device="cpu"),
            interop.params_from_numpy(params, device="cpu"))


def build(run, params0, mesh_knob):
    """The strategy of ``run`` over the mesh knob ``mesh_knob``."""
    cfg = dict(run.get("cfg", {}))
    if run.get("flush_k"):
        cfg["async_buffer"] = async_buffer.AsyncConfig(flush_k=run["flush_k"],
                                                       alpha=run.get("alpha", 0.5))
    if run.get("refresh"):
        cfg["w_refresh"] = RefreshConfig()
    if run.get("transport"):
        cfg["transport"] = TransportConfig(run["transport"])
    if run.get("faults"):
        cfg["faults"] = faults.FaultConfig(byzantine_frac=0.25, attack="sign_flip",
                                           drop_rate=0.2)
        cfg["robust"] = RobustConfig("trimmed_mean", trim_k=1)
    fcfg = FedConfig(**cfg, mesh=mesh_knob, shard_state=run.get("shard", False))
    return REGISTRY[run["name"]](lenet.apply_stacked, params0, fcfg, device="cpu",
                                 **run.get("kw", {}))


def play(run, data, params0, mesh_knob, *, spmd=False):
    """Init and the run's cohort rounds; returns what a rank reports."""
    strat = build(run, params0, mesh_knob)
    state = strat.init(None, data)
    metrics = []
    for r, ((idx, mask), perms) in enumerate(zip(run["cohorts"], run["perms"])):
        # (None, None) is a dense round
        cohort = None if idx is None else participation.Cohort(indices=idx, mask=mask)
        perms = torch.as_tensor(perms)
        if spmd and r == 0 and cohort is not None:
            mesh.check_spmd(mesh.resolve(mesh_knob), idx=torch.as_tensor(idx),
                            perm=perms.reshape(-1)[: perms.shape[-1]])
        state, met = strat.round(state, data, None, cohort, perms=perms)
        metrics.append({k: float(v) for k, v in met.items()
                        if isinstance(v, (int, float)) or (isinstance(v, torch.Tensor)
                                                           and v.dim() == 0)})
    rows = mesh.row_mesh(state)
    accs = client.evaluate(lenet.apply_stacked, strat.eval_params(state), data.x_test,
                           data.y_test, mesh=rows if rows is not None else mesh_knob)
    out = {k: state[k].numpy().copy() for k in SLABS if isinstance(state.get(k), torch.Tensor)}
    if state.get("abuf") is not None:
        out["upd"] = state["abuf"]["upd"].numpy().copy()
        out["buf_idx"] = state["abuf"]["idx"].numpy().copy()
    return dict(slabs=out, metrics=metrics, accs=accs.numpy().copy(),
                row_sharded=rows is not None)


def run_all(rank, seed, m, runs, sims=()):
    """Every run of ``runs`` on this rank over the default group
    (``mesh="auto"``), one torch thread, then each of ``sims``
    (:func:`simulate`)."""
    torch.set_num_threads(1)
    data, params0 = task(seed, m)
    out = {run["key"]: play(run, data, params0, "auto", spmd=True) for run in runs}
    for sim in sims:
        out[sim["key"]] = simulate(sim, data, params0, "auto")
    return out


def simulate(sim, data, params0, mesh_knob):
    """``simulation.run`` of the run ``sim`` at partial participation
    (``sim["fraction"]``) for ``sim["rounds"]`` rounds from seed 0, the
    evaluation sharded over the mesh (or the row-sharded state's own),
    ``verbose`` on; returns the history's accuracies, cohort sizes and
    params slab, and what the run printed."""
    strat = build(sim, params0, mesh_knob)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist = simulation.run(strat, lenet.apply_stacked, data, 0, rounds=sim["rounds"],
                              device="cpu", eval_mesh=mesh_knob, verbose=True,
                              participation=participation.ParticipationConfig(
                                  fraction=sim["fraction"]))
    return dict(avg=hist.avg_acc, worst=hist.worst_acc, printed=printed.getvalue(),
                sizes=[mt["cohort_size"] for mt in hist.metrics],
                params=hist.state["params"].numpy().copy(),
                row_sharded=mesh.row_mesh(hist.state) is not None)


def collectives(rank):
    """The mesh's two collectives and the row-sharded primitives on this
    rank's values, in rank order."""
    torch.set_num_threads(1)
    cm = mesh.resolve("auto")
    s = cm.shards
    mesh.reset_stats()
    mesh.TIMING = True
    summed = mesh.all_reduce_sum(torch.full((3, 4), float(rank + 1)), cm)
    mesh.TIMING = False
    timed = {k: dict(v) for k, v in mesh.STATS.items()}
    gathered = mesh.all_gather_rows(torch.full((2, 3), float(rank)), cm)
    flags = mesh.all_gather_rows(torch.tensor([rank % 2 == 0]), cm)
    m, width = 4 * s, 5
    full = torch.arange(m * width, dtype=torch.float32).reshape(m, width)
    lo, hi = cm.block(m)
    block = full[lo:hi].clone()
    safe = torch.tensor([m - 1, 0, 2, m - 1], dtype=torch.int32)
    got = mesh.shard_gather_rows(block, safe, cm)
    rows = -torch.ones(3, width)
    scattered = mesh.shard_scatter_rows(block, np.array([1, m - 2]), rows, cm)
    mean = mesh.row_mean(block, cm, m)
    drift = None
    try:
        mesh.check_spmd(cm, x=torch.tensor([rank]))
    except RuntimeError as e:
        drift = str(e)
    return dict(summed=summed.numpy(), gathered=gathered.numpy(), flags=flags.numpy(),
                gather=got.numpy(), scattered=scattered.numpy(), lo=lo, mean=mean.numpy(),
                block_mean=mesh.block_mean(full, cm).numpy(), drift=drift, timed=timed)


def fail_on(rank, bad):
    """Raise on rank ``bad``; the others wait at a barrier that never
    completes."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return rank


def hang(rank, seconds):
    """Outlive the caller's timeout."""
    time.sleep(seconds)
    return rank
