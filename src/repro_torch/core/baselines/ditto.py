"""Ditto (Li et al., 2021): a global model trained by FedAvg, and a
personal model per client trained with the pull λ·(v_i − θ_global)
towards the global model the client received. Evaluation uses the
personal models.

Each round draws two batch orders a client: one for the global model's
local SGD, then one for the personal model's. ``round(..., perms=)``
takes both, stacked as (2, m, epochs, ≥ steps·B). The cohort round
gathers the cohort's rows of both slabs (one ``cohort_gather`` launch
each); the personal solver pulls towards the gathered round-start global
rows, a copy, so the new global written before it does not reach it.

Wire: only the global model crosses it, a ``delta`` upload and the
``model`` broadcast delta-coded with the server's EF row; the personal
model never leaves the client. The upload stage (faults, robust) rewrites
the global model's upload only: its final mask weighs the mean, and every
real slot's personal model advances.
"""
from __future__ import annotations

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("ditto")
def make_ditto(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, lam: float = 0.5,
               device=None):
    def ditto_hook(g, p, center):
        return g + lam * (p - center)

    topology_lib.unsupported(
        cfg.topology, "ditto",
        "the round interleaves the global FedAvg leg with a client-side personal solver "
        "keyed to the same cohort gather — threading the two-tier mix through both legs "
        "is future work")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local_global = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    local_personal = common.local_sgd(apply_stacked, layout, cfg, grad_hook=ditto_hook,
                                      mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "ditto", layout.dim, downlink=(transport_lib.Stream("model", layout.dim),))
    up, down = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def init(gen, data):
        m = data.num_clients
        return {"params": layout.slab(params0, m), "personal": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        perms_g, perms_p = (None, None) if perms is None else perms
        params = state["params"]
        updated = local_global(params, data.x, data.y, gen=gen, perms=perms_g)
        new_global = aggregation.fedavg(updated, data.n)
        # the personal solver runs against the global the clients received
        personal = local_personal(state["personal"], data.x, data.y, params, gen=gen,
                                  perms=perms_p)
        return {"params": new_global, "personal": personal}, {"streams": 1}

    def masked(state, data, gen, idx, mask, perms):
        perms_g, perms_p = (None, None) if perms is None else perms
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  slabs=("params", "personal"), sops=sops)
        pc = co.rows["params"]
        post = local_global(pc, co.x, co.y, perms=co.keys(perms_g))
        out, gidx, gmask = {}, co.idx, co.mask
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        if ustage is not None:
            post, gidx, gmask = common.upload(ustage, co, pc, post)
        if down is None:
            new_global = sops.fedavg_mix(state["params"], post, gidx, gmask, data.n)
        else:
            new_global, out["ef_dl"] = sops.fedavg_mix(
                state["params"], post, gidx, gmask, data.n, dstage=down, ef_dl=state["ef_dl"])
        new_pc = local_personal(co.rows["personal"], co.x, co.y, pc, perms=co.keys(perms_p))
        personal = co.scatter(state["personal"], new_pc)
        return {"params": new_global, "personal": personal, **out}, {"streams": 1}

    return Strategy(f"ditto_lam{lam}", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "personal", "ef")),
                    lambda s: layout.unravel(s["personal"]),
                    comm_scheme="broadcast", num_streams=1,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
