"""Local training, no collaboration (the reference's lower bound).

The cohort round trains the cohort's rows and writes each real slot back
to its own row; pad slots write nothing. No downlink stream.
"""
from __future__ import annotations

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register


@register("local")
def make_local(apply_stacked, params0, cfg: FedConfig = FedConfig(), *, device=None):
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg)

    def init(gen, data):
        return {"params": layout.slab(params0, data.num_clients)}

    def dense(state, data, gen, perms):
        return {"params": local(state["params"], data.x, data.y, gen=gen, perms=perms)}, \
            {"streams": 0}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs)
        post = local(co.rows["params"], co.x, co.y, perms=co.keys(perms))
        return dict(state, params=aggregation.scatter_rows(state["params"], co.idx, post,
                                                           co.real)), {"streams": 0}

    return Strategy("local", init, common.cohort_round(dense, masked),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=0)
