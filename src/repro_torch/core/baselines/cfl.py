"""Clustered Federated Learning (Sattler et al., 2020): hard clustering.

FedAvg within each cluster (one ``mix_aggregate`` launch, k = m, dense;
``masked_group_rows`` in one ``masked_mix_scatter`` launch in a cohort
round). After ``warmup_rounds`` rounds, a cluster whose mean update is
small while its members' updates stay large (conflicting objectives) is
split in two by the sign of the leading eigenvector of the members'
pairwise cosine similarities (the spectral relaxation of Sattler's
min-max bipartition). The thresholds are relative, ‖mean Δ‖ <
eps1_rel·mean‖Δ_i‖, as in the reference.

The cluster bookkeeping runs on the host with numpy, as the reference's
does, and the assignment is a host int array. Every round past the
warm-up copies the update deltas of the clients that trained to the host
(the reference copies them in the warm-up rounds too, and reads them only
after it). A cohort round's real members are its slot prefix, so their
deltas are the first rows.

Upload stage (faults, robust): it runs before the split statistics, and
its final mask may have holes mid-cohort. Past the warm-up the round
brings that mask to the host with the deltas, as the reference does, and
the survivors alone form the member pool; in the warm-up rounds nothing
is read back and the streams are counted on the card.

Wire: a ``delta`` upload, quantized first, so the mix and the split
statistics read what the server decoded, ``post' − θ``; the
``cluster_models`` groupcast stays raw.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


def _spectral_bipartition(sim: np.ndarray) -> np.ndarray:
    """Sign split on the leading eigenvector of the centred similarity."""
    s = sim - sim.mean()
    v = np.random.default_rng(0).normal(size=s.shape[0])
    for _ in range(50):
        v = s @ v
        nrm = np.linalg.norm(v)
        if nrm < 1e-12:
            break
        v = v / nrm
    side = v >= 0
    if side.all() or (~side).all():  # degenerate: split by the median
        side = v >= np.median(v)
    return side


@register("cfl")
def make_cfl(apply_stacked, params0, cfg: FedConfig = FedConfig(), *,
             eps1_rel: float = 0.4, warmup_rounds: int = 3, min_cluster: int = 4,
             device=None):
    topology_lib.unsupported(
        cfg.topology, "cfl",
        "the split check consumes every surviving member's PER-CLIENT update-delta row "
        "at the host each round — per-edge partial means would erase the rows the "
        "spectral bipartition needs")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    local = common.local_sgd(apply_stacked, layout, cfg, mesh=sops.mesh)
    schema = transport_lib.single_delta_schema(
        "cfl", layout.dim,
        downlink=(transport_lib.Stream("cluster_models", layout.dim, coding="raw"),))
    up, _ = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def init(gen, data):
        m = data.num_clients
        return {"params": layout.slab(params0, m), "assignment": np.zeros(m, dtype=np.int32),
                "round": 0, **common.wire_state(schema, cfg.transport, m, dev)}

    def maybe_split(assignment, members_pool, dmat_rows):
        """The bipartition check over the clients in ``members_pool``;
        ``dmat_rows`` maps a client id to its update-delta row."""
        assignment = assignment.copy()
        next_id = assignment.max() + 1
        for c in np.unique(assignment[members_pool]):
            members = members_pool[assignment[members_pool] == c]
            if len(members) < min_cluster:
                continue
            d = np.stack([dmat_rows[i] for i in members])
            norms = np.linalg.norm(d, axis=1)
            mean_norm = np.linalg.norm(d.mean(axis=0))
            if mean_norm < eps1_rel * norms.mean():
                nd = d / np.maximum(norms[:, None], 1e-12)
                side = _spectral_bipartition(nd @ nd.T)
                if side.any() and (~side).any():
                    assignment[members[side]] = next_id
                    next_id += 1
        return assignment

    def bookkeep(state, pool, delta):
        """The next (assignment, round); ``delta`` holds the pool's update
        deltas as its first rows, on the card."""
        assignment = state["assignment"]
        rnd = state["round"] + 1
        if rnd > warmup_rounds:
            dmat = delta[: len(pool)].cpu().numpy()
            assignment = maybe_split(assignment, pool, dict(zip(pool.tolist(), dmat)))
        return assignment, rnd

    def staged_streams(state, co, delta, fmask, assignment_c):
        """(assignment, round, streams) of a round under the upload stage:
        past the warm-up the final mask and the deltas come to the host and
        the survivors form the pool; before it the clusters present are
        counted on the card."""
        if state["round"] + 1 > warmup_rounds:
            slots = np.nonzero(fmask.cpu().numpy())[0]
            pool = co.members[slots]  # the survivors lie in the real prefix
            assignment, rnd = bookkeep(state, pool, delta[torch.as_tensor(slots, device=dev)])
            return assignment, rnd, len(np.unique(assignment[pool])) if len(pool) else 0
        return (state["assignment"], state["round"] + 1,
                common.groups_present(assignment_c, int(state["assignment"].max()) + 1, fmask))

    def dense(state, data, gen, perms):
        params, assignment = state["params"], state["assignment"]
        post = local(params, data.x, data.y, gen=gen, perms=perms)
        new = common.group_average(post, torch.as_tensor(assignment, device=dev), data.n)
        assignment, rnd = bookkeep(state, np.arange(len(assignment)), post - params)
        return ({"params": new, "assignment": assignment, "round": rnd},
                {"streams": len(np.unique(assignment))})

    def masked(state, data, gen, idx, mask, perms):
        assignment = state["assignment"]
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        pc = co.rows["params"]
        post = local(pc, co.x, co.y, perms=co.keys(perms))
        out = {}
        if up is not None:
            post, out["ef"] = common.uplink(up, state, co, pc, post)
        fidx, fmask = co.idx, co.mask
        if ustage is not None:
            post, fidx, fmask = common.upload(ustage, co, pc, post)
        assignment_c = torch.as_tensor(assignment[np.minimum(idx, data.num_clients - 1)],
                                       device=dev)
        rows = aggregation.masked_group_rows(assignment_c, data.n[co.safe], fmask)
        new = sops.mix_scatter_flat(state["params"], post, rows, fidx, fmask)
        if ustage is None:
            assignment, rnd = bookkeep(state, co.members, post - pc)
            streams = len(np.unique(assignment[co.members])) if co.real else 0
        else:
            assignment, rnd, streams = staged_streams(state, co, post - pc, fmask, assignment_c)
        return ({"params": new, "assignment": assignment, "round": rnd, **out},
                {"streams": streams})

    return Strategy("cfl", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "ef")),
                    lambda s: layout.unravel(s["params"]),
                    comm_scheme="groupcast", injects_faults=cfg.faults is not None,
                    wire_schema=schema)
