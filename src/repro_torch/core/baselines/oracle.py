"""Oracle: FedAvg within each of the data's true groups (the paper's
upper bound).

Dense: one ``mix_aggregate`` launch, k = m, of the group rule. Cohort
round: each real slot averages the real uploads of its group
(``masked_group_rows``), mixed and scattered in one ``masked_mix_scatter``
launch; absent clients keep their last model. The downlink streams are
the groups present, counted on the host (under the upload stage, from its
final mask on the card). Wire: a ``delta`` upload; the
``group_models`` groupcast stays raw (a group mean is no receiver's old
model to delta-code against).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("oracle")
def make_oracle(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, device=None):
    topology_lib.unsupported(
        cfg.topology, "oracle",
        "per-group FedAvg factorizes over groups, but ground-truth group membership "
        "crosscuts the static edge assignment — a (group × edge) partial-sum layout is "
        "future work")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "oracle", layout.dim,
        downlink=(transport_lib.Stream("group_models", layout.dim, coding="raw"),))
    up, _ = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def init(gen, data):
        # the cohort round counts its streams from this copy, not with a
        # device sync every round
        group_host = data.group.cpu().numpy()
        m = data.num_clients
        return {"params": layout.slab(params0, m), "group_host": group_host,
                "num_groups": int(group_host.max()) + 1,
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        updated = local(state["params"], data.x, data.y, gen=gen, perms=perms)
        new = common.group_average(updated, data.group, data.n)
        return dict(state, params=new), {"streams": state["num_groups"]}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        if ustage is None:
            fidx, fmask = co.idx, co.mask
            streams = int(np.unique(state["group_host"][co.members]).size)
        else:
            post, fidx, fmask = common.upload(ustage, co, pc, post)
            streams = common.groups_present(data.group[co.safe], state["num_groups"], fmask)
        rows = aggregation.masked_group_rows(data.group[co.safe], data.n[co.safe], fmask)
        new = sops.mix_scatter_flat(state["params"], post, rows, fidx, fmask)
        return dict(state, params=new, **out), {"streams": streams}

    return Strategy("oracle", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="groupcast", injects_faults=cfg.faults is not None,
                    wire_schema=schema)
