"""Local training, no collaboration (the reference's lower bound).

The cohort round trains the cohort's rows and writes each real slot back
to its own row; pad slots write nothing, and neither does a slot that the
upload stage (faults, robust) demoted. No downlink stream. Wire: a
``delta`` upload only; each row keeps what the server decoded.
"""
from __future__ import annotations

from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("local")
def make_local(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, device=None):
    topology_lib.unsupported(
        cfg.topology, "local",
        "no collaboration — each participant's upload scatters back to its own row, so "
        "there is no aggregate for an edge tier to form")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema("local", layout.dim)
    up, _ = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def init(gen, data):
        m = data.num_clients
        return {"params": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        return {"params": local(state["params"], data.x, data.y, gen=gen, perms=perms)}, \
            {"streams": 0}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        if ustage is not None:
            post, _, fmask = common.upload(ustage, co, pc, post)
            post = common.kept(fmask, post, pc)
        return dict(state, params=co.scatter(state["params"], post), **out), {"streams": 0}

    return Strategy("local", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=0,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
