"""FedAvg (McMahan et al., 2017): Eq. 1.

Dense: every client trains from the global model, and the n-weighted mean
of the uploads (one ``mix_aggregate`` launch, k = 1) is broadcast back to
every row of the slab. Cohort round: the cohort trains from the global,
and the mean of its real uploads (k = 1 over the (c, d) uploads) is
broadcast, pad slots weighing 0. One downlink stream either way.

Wire: a ``delta`` upload, and the broadcast delta-coded as the ``model``
stream against the old global with the server's EF row. Upload stage
(faults, robust): the final mask weighs the mean.

Buffered-async (``FedConfig.async_buffer``): the cohort's deltas are
banked, and a flush adds their staleness-weighted n-mean to the global
(k = 1 over the buffer's rows). Two-tier (``FedConfig.topology``): the
mean as per-edge aggregates and their mass-weighted combine, two
``mix_aggregate`` launches, then the same broadcast. The two knobs do not
compose.
"""
from __future__ import annotations

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("fedavg")
def make_fedavg(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, device=None):
    topo = topology_lib.check_composition(cfg.topology, "fedavg", shard_state=cfg.shard_state,
                                          async_buffer=cfg.async_buffer)
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "fedavg", layout.dim, downlink=(transport_lib.Stream("model", layout.dim),))

    def init(gen, data):
        m = data.num_clients
        if topo is not None:
            topo.check_clients(m, "fedavg")
        return {"params": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        updated = local(state["params"], data.x, data.y, gen=gen, perms=perms)
        return {"params": aggregation.fedavg(updated, data.n)}, {"streams": 1}

    def train(co, perms):
        return local(co.rows["params"], co.x, co.y, perms=co.keys(perms))

    ustage = common.upload_stage(cfg, schema)
    masked = common.make_fedavg_masked_round(train, dev=dev, epochs=cfg.epochs, schema=schema,
                                             transport=cfg.transport, stage=ustage, topology=topo,
                                             sops=sops)
    amasked = common.fedavg_async_wrapper(train, cfg.async_buffer, dev=dev, epochs=cfg.epochs,
                                          schema=schema, transport=cfg.transport, stage=ustage,
                                          dim=layout.dim, sops=sops)

    return Strategy("fedavg", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_fn=amasked, async_cfg=cfg.async_buffer,
                                        topology=topo, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=1,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
