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
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register


def _mean_row(slab):
    """The mean of the rows, one copy a client."""
    return torch.mean(slab, dim=0).expand_as(slab).clone()


@register("scaffold")
def make_scaffold(apply_stacked, params0,
                  cfg: FedConfig = FedConfig(lr=0.01, momentum=0.0, epochs=5), *, device=None):
    def control_hook(g, p, ctrl):
        c_i, c = ctrl
        return g - c_i + c

    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, grad_hook=control_hook)

    def init(gen, data):
        stacked = layout.slab(params0, data.num_clients)
        return {"params": stacked, "c_i": torch.zeros_like(stacked),
                "c": torch.zeros_like(stacked)}

    def inv_steps(data):
        """1 / (K·η)."""
        return 1.0 / ((data.y.shape[1] // cfg.batch_size) * cfg.epochs * cfg.lr)

    def dense(state, data, gen, perms):
        params, c_i, c = state["params"], state["c_i"], state["c"]
        post = local(params, data.x, data.y, (c_i, c), gen=gen, perms=perms)
        new_c_i = c_i - c + inv_steps(data) * (params - post)
        return ({"params": aggregation.fedavg(post, data.n), "c_i": new_c_i,
                 "c": _mean_row(new_c_i)}, {"streams": 1})

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  slabs=("params", "c_i", "c"))
        pc, cic, cc = (co.rows[k] for k in ("params", "c_i", "c"))
        post = local(pc, co.x, co.y, (cic, cc), perms=co.keys(perms))
        new_cic = cic - cc + inv_steps(data) * (pc - post)
        c_i = aggregation.scatter_rows(state["c_i"], co.idx, new_cic, co.real)
        params = common.fedavg_masked_mix(state["params"], post, co.idx, co.mask, data.n)
        return {"params": params, "c_i": c_i, "c": _mean_row(c_i)}, {"streams": 1}

    return Strategy("scaffold", init, common.cohort_round(dense, masked),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="broadcast", num_streams=1)
