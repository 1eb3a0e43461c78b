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
from repro_torch import checkpoint, interop
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


def play(run, data, params0, mesh_knob, *, spmd=False, ckpt=None):
    """Init and the run's cohort rounds; returns what a rank reports. With
    ``ckpt`` (a file path), the final state is also saved there
    (``checkpoint.save``: gathered when row-sharded), restored into
    itself, and converted with ``interop.state_to_reference``: the report
    says whether the restore gave the state's bits and holds the
    converted params slab."""
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
    saved = None
    if ckpt is not None:
        checkpoint.save(ckpt, state)
        back = checkpoint.restore(ckpt, state)
        same = all(torch.equal(back[k], state[k]) for k in SLABS
                   if isinstance(state.get(k), torch.Tensor))
        if rows is not None:
            same = same and mesh.row_mesh(back) is not None
        conv = interop.state_to_reference(state, params0_dim(params0))
        saved = dict(restored=same, converted=conv["params"].numpy().copy())
    accs = client.evaluate(lenet.apply_stacked, strat.eval_params(state), data.x_test,
                           data.y_test, mesh=rows if rows is not None else mesh_knob)
    out = {k: state[k].numpy().copy() for k in SLABS if isinstance(state.get(k), torch.Tensor)}
    if state.get("abuf") is not None:
        out["upd"] = state["abuf"]["upd"].numpy().copy()
        out["buf_idx"] = state["abuf"]["idx"].numpy().copy()
    return dict(slabs=out, metrics=metrics, accs=accs.numpy().copy(),
                row_sharded=rows is not None, saved=saved)


def params0_dim(params0):
    return sum(v.numel() for v in params0.values())


def run_all(rank, seed, m, runs, sims=(), ckpt_dir=None):
    """Every run of ``runs`` on this rank over the default group
    (``mesh="auto"``), one torch thread, then each of ``sims``
    (:func:`simulate`). A run with ``"ckpt": name`` saves its final state
    to ``ckpt_dir/name``."""
    torch.set_num_threads(1)
    data, params0 = task(seed, m)
    out = {run["key"]: play(run, data, params0, "auto", spmd=True,
                            ckpt=f"{ckpt_dir}/{run['ckpt']}" if run.get("ckpt") else None)
           for run in runs}
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


# ----------------------------------------------- expert parallelism (2-D mesh)

EP_MOE = dict(d_model=32, d_ff=64, num_experts=8, top_k=2)  # the reference test's MoE
EP_SEED = 1
# the client-sharded train step: reduced stablelm, 4 clients, 2 requests of
# 12 tokens each
GATHER_ARCH, GATHER_CLIENTS, GATHER_BATCH, GATHER_SEQ = "stablelm-1.6b", 4, 2, 12


def ep_train_config():
    """Reduced kimi-k2 in f32 at capacity factor 8: nothing drops (cap2 at
    the default cf2 1.5 still holds every row an expert can receive)."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("kimi-k2-1t-a32b").reduced(), capacity_factor=8.0)


def ep_train_batch(cfg, batch=8, seq=12):
    """A global (B, S) next-token batch from a fixed seed."""
    gen = torch.Generator().manual_seed(EP_SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def ep_fedsgd_step(cfg, params, batch):
    """One fedsgd step of ``cfg`` (lr 0.1, the config's momentum)."""
    from repro_torch.launch import steps
    from repro_torch.optim import sgd_init
    step = steps.build_train_step(cfg, n_clients=1, agg="local", lr=0.1, momentum=cfg.momentum)
    return step(params, sgd_init(params, momentum=cfg.momentum), batch)


def ep_serve(mesh):
    """``serve()`` of reduced kimi-k2 at capacity factor 8 (nothing drops)
    on ``mesh``: 4 requests of a 6-token prompt, 4 greedy tokens."""
    from repro_torch.launch import serve
    return serve.serve(ep_train_config(), clients=1, batch=4, prompt_len=6, decode_tokens=4,
                       seed=EP_SEED, device="cpu", mesh=mesh)


def gather_task():
    """The client-sharded step's inputs: reduced stablelm's personalized
    params of GATHER_CLIENTS clients, a batch, a row-stochastic W, 2
    centroid rules and labels."""
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get(GATHER_ARCH).reduced()
    params = serve.personalized_params(cfg, GATHER_CLIENTS, EP_SEED, "cpu")
    gen = torch.Generator().manual_seed(EP_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (GATHER_CLIENTS, GATHER_BATCH, GATHER_SEQ + 1),
                         generator=gen)
    w = torch.rand(GATHER_CLIENTS, GATHER_CLIENTS, generator=gen)
    rules = torch.rand(2, GATHER_CLIENTS, generator=gen)
    mix = {"user_centric": w / w.sum(1, keepdim=True),
           "clustered": (rules / rules.sum(1, keepdim=True), torch.tensor([0, 1, 1, 0])),
           "fedavg": (), "local": ()}
    return cfg, params, {"tokens": toks[..., :-1], "labels": toks[..., 1:]}, mix


def gather_step(cfg, agg, params, mix, batch, placement=None):
    """One user-centric-family train step (lr 0.1, momentum 0.9) from a
    fresh optimizer, its rows mixed over ``placement`` when given."""
    from repro_torch.launch import steps
    from repro_torch.optim import sgd_init
    step = steps.build_train_step(cfg, n_clients=GATHER_CLIENTS, agg=agg,
                                  mix_gather_shardings=placement)
    return step(params, sgd_init(params, momentum=0.9), mix, batch)


def _np_tree(tree):
    from repro_torch.core.pytree import leaves
    return [x.detach().numpy().copy() for x in leaves(tree)]


def ep_rank(rank, shape, names, inp_path):
    """One rank of the expert-parallel tests on an N-D mesh of ``shape``:

      * the small MoE (``EP_MOE``) on this rank's batch slice and expert
        block, from the parent's numpy inputs: y, aux and the drops at
        capacity factor 1.25 / cf2 1.5, and the gradients of Σ y·r +
        aux / (pods · data ranks) (the ranks' objectives sum to the
        reference's Σ y·r + aux); y at cf = cf2 = 8;
      * one fedsgd step of reduced kimi-k2 (``ep_train_config``) on the
        rank's params (``sharding.rank_params``) and batch slice;
      * on a 2-rank mesh, one step of each agg with the mix placed over
        the mesh (``mix_gather_shardings``: the RankMesh, and for
        user_centric a ClientMesh too) on the rank's 2 of 4 clients.
    """
    import dataclasses
    from repro_torch.federated import mesh as mesh_lib
    from repro_torch.launch import mesh as rank_mesh
    from repro_torch.launch import sharding
    from repro_torch.models import moe
    torch.set_num_threads(1)
    mesh = rank_mesh.make_mesh(shape, names)
    inp = np.load(inp_path)
    pods, data, model = mesh.shape.get("pod", 1), mesh.shape["data"], mesh.shape["model"]
    clients = mesh.clients()
    out = {"coords": dict(mesh.coords)}
    # --- the MoE layer
    cfg = moe.MoEConfig(**EP_MOE, ep_axis="data")
    whole = {k: torch.from_numpy(inp[k])[None] for k in ("router", "w_gate", "w_up", "w_down")}
    blk = sharding.rank_block({"moe": whole}, _moe_model_cfg(), mesh)["moe"]
    blk = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
    b = inp["x"].shape[0] // clients.shards
    lo = clients.rank * b
    x = torch.from_numpy(inp["x"][lo:lo + b])[None].requires_grad_(True)
    r = torch.from_numpy(inp["r"][lo:lo + b])[None]
    moe.set_ep_mesh(mesh)
    try:
        y, aux = moe.apply_expert_parallel(blk, x, cfg, cf2=1.5)
        at_cap, at_cap2, tokens = moe.ep_dropped(blk, x, cfg, cf2=1.5)
        ((y * r).sum() + aux.sum() / clients.shards).backward()
        out.update(y=y.detach()[0].numpy(), aux=float(aux.detach()[0]), at_cap=int(at_cap[0]),
                   at_cap2=int(at_cap2[0]), dropped_tokens=int(tokens.sum()),
                   gx=x.grad[0].numpy(), **{f"g_{k}": v.grad[0].numpy() for k, v in blk.items()})
        big = dataclasses.replace(cfg, capacity_factor=8.0)
        with torch.no_grad():
            out["y8"] = moe.apply_expert_parallel(blk, x, big, cf2=8.0)[0][0].numpy()
            out["drops8"] = [int(t.sum()) for t in moe.ep_dropped(blk, x, big, cf2=8.0)[:2]]
            # two clients folded into the sorts: the second client's weights and
            # tokens are others; against the sort dispatch on the whole experts
            two = {k: torch.cat([v, v.flip(-1) * 0.9]) for k, v in whole.items()}
            x2 = torch.cat([x, x.flip(2)]).detach()
            y2, aux2 = moe.apply_expert_parallel(
                sharding.rank_block({"moe": two}, _moe_model_cfg(), mesh)["moe"], x2, big,
                cf2=8.0)
            plain = dataclasses.replace(big, ep_axis=None)
            want2, _ = moe.apply(two, x2, plain)
            whole_x = torch.from_numpy(inp["x"])[None]
            _, want_aux2 = moe.apply(two, torch.cat([whole_x, whole_x.flip(2)]), plain)
            out["y2_err"] = float((y2 - want2).abs().max())
            out["aux2_err"] = float((aux2 - want_aux2).abs().max())
            # bf16 weights and tokens (the router f32) at cf 1.25 / cf2 1.5
            bf = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in blk.items()}
            out["y_bf16"] = moe.apply_expert_parallel(bf, x.to(torch.bfloat16), cfg,
                                                      cf2=1.5)[0][0].float().numpy()
        # --- the fedsgd step under expert parallelism
        tcfg = ep_train_config()
        params = sharding.rank_params(tcfg, EP_SEED, mesh, "cpu")
        batch = ep_train_batch(tcfg)
        bl = batch["tokens"].shape[0] // clients.shards
        mine = {k: v[clients.rank * bl:(clients.rank + 1) * bl] for k, v in batch.items()}
        mesh_lib.reset_stats()
        new, _, met = ep_fedsgd_step(tcfg, params, mine)
        out.update(step=_np_tree(new), step_loss=float(met["loss"]),
                   collectives={k: v["calls"] for k, v in mesh_lib.STATS.items()},
                   gathered=_np_tree(sharding.gather_blocks(params, tcfg, mesh)))
    finally:
        moe.set_ep_mesh(None)
    # --- serve() on the mesh: this rank's requests, the experts sharded
    res = ep_serve(mesh)
    out["served"] = dict(tokens=res.tokens.numpy(), logits=res.logits.numpy())
    assert moe.ep_mesh() is None
    # --- the client-sharded train step
    if mesh.size == 2:
        gcfg, gparams, gbatch, mixes = gather_task()
        lo, hi = clients.block(GATHER_CLIENTS)
        rows = lambda t: t[lo:hi]  # noqa: E731
        from repro_torch.core.pytree import tree_map
        for agg, mix in mixes.items():
            for name, placement in (("rank_mesh", mesh), ("client_mesh", mesh_lib.resolve("auto"))):
                if name == "client_mesh" and agg != "user_centric":
                    continue
                new, _, met = gather_step(gcfg, agg, tree_map(rows, gparams), mix,
                                          tree_map(rows, gbatch), placement)
                out[f"gather_{agg}_{name}"] = dict(params=_np_tree(new), loss=float(met["loss"]))
    return out


def _moe_model_cfg():
    """kimi-k2's config (its expert axis "data") with the small MoE's
    experts and d_ff, for ``sharding``'s block bounds."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("kimi-k2-1t-a32b"),
                               moe_num_experts=EP_MOE["num_experts"], moe_d_ff=EP_MOE["d_ff"])
