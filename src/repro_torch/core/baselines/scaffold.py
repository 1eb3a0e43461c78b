"""SCAFFOLD (Karimireddy et al., 2019): stochastic controlled averaging.

Local step: θ ← θ − η(∇f_i(θ) − c_i + c). Control update (option II):
c_i⁺ = c_i − c + (θ_global − θ_i⁺)/(K·η), K the local steps of a round.
The server sets θ to the n-weighted mean of the uploads and c to the mean
of all m stored c_i. The paper's footnote 2: η = 0.01, 5 epochs, no
momentum.

State: three (m, dim_aligned) slabs, ``params``, ``c_i`` and ``c`` (the
global c, one copy a client). The cohort round gathers the cohort's rows
of all three (one ``cohort_gather`` launch each), refreshes the cohort's
c_i only (pad slots write nothing), re-averages every stored c_i, stale
ones included, and broadcasts the mean of the real uploads.

Wire: two streams each way. Up, ``delta`` and ``control_delta``: the
client derives its new control from its raw local model first, then the
stage quantizes ``[post | c_i⁺]`` against ``[θ | c_i]``, each half with
its own EF slice, so the EF slab is (m, 2·dim_aligned). Down, ``model``
and ``control``: ``[new global | new c]`` delta-coded against row 0 of
``[params | c]`` with one server EF row.

Upload stage (faults, robust): on the same ``[post | c_i⁺]`` wire slab,
after the wire stage, with the finite guard per stream; a demoted slot
keeps its c_i row, and the final mask weighs the mean.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("scaffold")
def make_scaffold(apply_stacked, params0,
                  cfg: FedConfig = FedConfig(lr=0.01, momentum=0.0, epochs=5), *, device=None):
    def control_hook(g, p, ctrl):
        c_i, c = ctrl
        return g - c_i + c

    topology_lib.unsupported(
        cfg.topology, "scaffold",
        "option II couples every client's control variate to ONE global c re-averaged "
        "over all m stored c_i rows each round — per-edge partial means of the cohort's "
        "c_i⁺ are not that update")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, grad_hook=control_hook, mesh=sops.mesh)
    schema = transport_lib.WireSchema(
        "scaffold",
        uplink=(transport_lib.Stream("delta", layout.dim),
                transport_lib.Stream("control_delta", layout.dim)),
        downlink=(transport_lib.Stream("model", layout.dim),
                  transport_lib.Stream("control", layout.dim)))
    up, down = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)
    width = layout.dim_aligned  # one stream's slice of the wire slab

    def init(gen, data):
        m = data.num_clients
        stacked = layout.slab(params0, m)
        return {"params": stacked, "c_i": torch.zeros_like(stacked),
                "c": torch.zeros_like(stacked),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def mean_row(slab, m):
        """The mean of all m stored rows (:meth:`common.StateOps.row_mean`),
        one copy a row of ``slab`` (the rank's block when row-sharded)."""
        return sops.row_mean(slab, m).expand_as(slab).clone()

    def inv_steps(data):
        """1 / (K·η)."""
        return 1.0 / ((data.y.shape[1] // cfg.batch_size) * cfg.epochs * cfg.lr)

    def dense(state, data, gen, perms):
        params, c_i, c = state["params"], state["c_i"], state["c"]
        post = local(params, data.x, data.y, (c_i, c), gen=gen, perms=perms)
        new_c_i = c_i - c + inv_steps(data) * (params - post)
        return ({"params": aggregation.fedavg(post, data.n), "c_i": new_c_i,
                 "c": mean_row(new_c_i, data.num_clients)}, {"streams": 1})

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  slabs=("params", "c_i", "c"), sops=sops)
        pc, cic, cc = (co.rows[k] for k in ("params", "c_i", "c"))
        post = local(pc, co.x, co.y, (cic, cc), perms=co.keys(perms))
        new_cic = cic - cc + inv_steps(data) * (pc - post)
        out, fidx, fmask = {}, co.idx, co.mask
        if up is not None or ustage is not None:
            # the wire carries [model | control]: the client derives its new
            # control from its raw local model, then the wire stage and the
            # upload stage rewrite both halves
            pre = torch.cat([pc, cic], dim=1)
            wire = torch.cat([post, new_cic], dim=1)
            if up is not None:
                wire, out["ef"] = common.uplink(up, state, co, pre, wire)
            if ustage is not None:
                wire, fidx, fmask = common.upload(ustage, co, pre, wire)
                wire = common.kept(fmask, wire, pre)
            post, new_cic = wire[:, :width], wire[:, width:]
        c_i = co.scatter(state["c_i"], new_cic)
        if down is None:
            params = sops.fedavg_mix(state["params"], post, fidx, fmask, data.n)
            return ({"params": params, "c_i": c_i, "c": mean_row(c_i, co.m), **out},
                    {"streams": 1})
        # the downlink: both broadcast rows against the old [global | c]
        params, c = state["params"], state["c"]
        w = aggregation.masked_fedavg_weights(data.n[co.safe], fmask)
        mixed = aggregation.user_centric(post, w)  # (1, width)
        dl_post = torch.cat([mixed, sops.row_mean(c_i, co.m)], dim=1)
        served, new_ef_dl = down(torch.cat([sops.row0(params), sops.row0(c)], dim=1), dl_post,
                                 state["ef_dl"])
        alive = torch.any(fmask)
        return {"params": torch.where(alive, served[:, :width].expand_as(params), params),
                "c_i": c_i,
                "c": torch.where(alive, served[:, width:].expand_as(c), c),
                "ef_dl": torch.where(alive, new_ef_dl, state["ef_dl"]), **out}, \
            {"streams": 1}

    return Strategy("scaffold", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "c_i", "c", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=1,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
