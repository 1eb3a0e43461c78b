"""FedProx (Li et al., 2018): FedAvg with the proximal term
μ/2·||θ − θ_global||² in every local step, centred at the model the round
started from. Its wire is FedAvg's: a ``delta`` upload and a delta-coded
``model`` broadcast; so are its buffered-async round and its two-tier
mix (:mod:`repro_torch.core.baselines.fedavg`)."""
from __future__ import annotations

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("fedprox")
def make_fedprox(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, mu: float = 0.1,
                 device=None):
    def prox_hook(g, p, center):
        return g + mu * (p - center)

    topo = topology_lib.check_composition(cfg.topology, "fedprox", shard_state=cfg.shard_state,
                                          async_buffer=cfg.async_buffer)
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, grad_hook=prox_hook, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "fedprox", layout.dim, downlink=(transport_lib.Stream("model", layout.dim),))

    def init(gen, data):
        m = data.num_clients
        if topo is not None:
            topo.check_clients(m, "fedprox")
        return {"params": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        params = state["params"]
        updated = local(params, data.x, data.y, params, gen=gen, perms=perms)
        return {"params": aggregation.fedavg(updated, data.n)}, {"streams": 1}

    def train(co, perms):
        pc = co.rows["params"]
        return local(pc, co.x, co.y, pc, perms=co.keys(perms))  # centred at the round's start

    ustage = common.upload_stage(cfg, schema)
    masked = common.make_fedavg_masked_round(train, dev=dev, epochs=cfg.epochs, schema=schema,
                                             transport=cfg.transport, stage=ustage, topology=topo,
                                             sops=sops)
    amasked = common.fedavg_async_wrapper(train, cfg.async_buffer, dev=dev, epochs=cfg.epochs,
                                          schema=schema, transport=cfg.transport, stage=ustage,
                                          dim=layout.dim, sops=sops)

    return Strategy(f"fedprox_mu{mu}", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_fn=amasked, async_cfg=cfg.async_buffer,
                                        topology=topo, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=1,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
