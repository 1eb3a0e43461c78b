"""pFedMe (Dinh et al., 2020): Moreau-envelope personalization.

For each batch the client approximately solves the proximal inner problem
  φ ≈ argmin_φ f̃_i(φ; batch) + (λ/2)||φ − w_i||²
with S gradient steps from φ = w_i, then moves its local copy
w_i ← w_i − η·λ·(w_i − φ). The server averages the w_i and each client
takes (1 − β)·w_i + β·average. Evaluation uses the personalized φ_i. The
paper's footnote 2: η = 0.01, S = 15, 1 epoch, batch 20, no momentum.

Every inner step is one backward pass of all the clients' models at once,
dispatched from Python: at m = 100 and n = 1000 a round is 50 batches ×
15 inner steps = 750 of them. The cohort round trains the gathered rows
(one ``cohort_gather`` launch), mixes with the cohort's own mean (the
cohort-shaped broadcast) and writes the real slots of both slabs back.

Wire: a ``delta`` upload of w; the server's average reads the dequantized
uploads, the (1 − β) retention each client's raw w. The ``average``
downlink stays raw (the β-mix has no shared receiver reference).

Upload stage (faults, robust): on the w upload, after the wire stage. Its
final mask weighs the average, and a demoted slot keeps its w row;
without the wire stage the retention reads what the stage left (the
reference's path). φ is the client's own, and every real slot's advances.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.core.baselines import common
from repro_torch.core.strategy import FedConfig, Strategy, register
from repro_torch.data.loader import draw_permutations
from repro_torch.federated import client as fedclient
from repro_torch.federated import mesh as mesh_lib
from repro_torch.federated import topology as topology_lib
from repro_torch.federated import transport as transport_lib


@register("pfedme")
def make_pfedme(apply_stacked, params0,
                cfg: FedConfig = FedConfig(lr=0.01, momentum=0.0, epochs=1, batch_size=20), *,
                lam: float = 15.0, inner_steps: int = 15, inner_lr: float = 0.01,
                beta: float = 1.0, device=None):
    topology_lib.unsupported(
        cfg.topology, "pfedme",
        "the β-mix blends each participant's RAW w_i with the cohort average CLIENT-"
        "side — the served value is per-client, not a broadcast aggregate an edge tier "
        "could relay")
    sops = common.StateOps(cfg.mesh, cfg.shard_state)
    params0, layout, dev = common.prepare(params0, device)
    bsz = cfg.batch_size
    schema = transport_lib.single_delta_schema(
        "pfedme", layout.dim,
        downlink=(transport_lib.Stream("average", layout.dim, coding="raw"),))
    up, _ = common.wire_stages(schema, cfg.transport)
    ustage = common.upload_stage(cfg, schema)

    def client_update(w, x, y, perms):
        """(U, dim_aligned) local copies -> (new w, last φ)."""
        units, n = y.shape
        steps = n // bsz
        rows = torch.arange(units, device=w.device)[:, None]
        w = w.detach()
        phi = w
        for e in range(cfg.epochs):
            order = perms[:, e, : steps * bsz]
            for s in range(steps):
                idx = order[:, s * bsz: (s + 1) * bsz]
                bx, by = x[rows, idx], y[rows, idx]
                phi = w
                for _ in range(inner_steps):
                    g = fedclient.full_gradients(apply_stacked, layout, phi, bx, by)
                    phi = phi - inner_lr * (g + lam * (phi - w))
                w = w - cfg.lr * lam * (w - phi)
        return w, phi

    def chunked(w, x, y, perms):
        """:func:`client_update` in chunks of ``cfg.chunk_size`` clients."""
        new_w, phi = torch.empty_like(w), torch.empty_like(w)
        for sl in fedclient.chunks(w.shape[0], cfg.chunk_size):
            new_w[sl], phi[sl] = client_update(w[sl], x[sl], y[sl], perms[sl])
        return new_w, phi

    sharded = chunked if sops.mesh is None else mesh_lib.shard_clients(chunked, sops.mesh)

    def run_clients(w, x, y, perms):
        """:func:`client_update` over the clients, each rank on its block of
        them under the mesh (chunked within it)."""
        if sops.mesh is not None and w.shape[0] % sops.mesh.shards == 0:
            return sharded(w, x, y, perms)
        return chunked(w, x, y, perms)

    def init(gen, data):
        m = data.num_clients
        return {"params": layout.slab(params0, m), "personal": layout.slab(params0, m),
                **common.wire_state(schema, cfg.transport, m, dev)}

    def dense(state, data, gen, perms):
        m, n = data.y.shape
        if perms is None:
            perms = draw_permutations(gen, m, cfg.epochs, n, device=dev)
        new_w, phi = run_clients(state["params"], data.x, data.y, perms)
        avg = aggregation.fedavg(new_w, data.n)
        return {"params": (1 - beta) * new_w + beta * avg, "personal": phi}, {"streams": 1}

    def masked(state, data, gen, idx, mask, perms):
        co = common.gather_cohort(state, data, gen, idx, mask, dev=dev, epochs=cfg.epochs,
                                  sops=sops)
        wc = co.rows["params"]
        new_wc, phic = run_clients(wc, co.x, co.y, co.keys(perms))
        out, wire, widx, wmask, final = {}, new_wc, co.idx, co.mask, None
        if up is not None:
            wire, out["ef"] = common.uplink(up, state, co, wc, new_wc)
        if ustage is not None:
            wire, widx, wmask = common.upload(ustage, co, wc, wire)
            final = wmask
            if up is None:
                new_wc = wire
        # the cohort-shaped broadcast: every slot gets the real slots' mean
        avg = common.fedavg_masked_mix(wc, wire, widx, wmask, data.n)
        w = co.scatter(state["params"], common.kept(final, (1 - beta) * new_wc + beta * avg, wc))
        personal = co.scatter(state["personal"], phic)
        return {"params": w, "personal": personal, **out}, {"streams": 1}

    return Strategy("pfedme", init,
                    common.cohort_round(dense, masked, transport=cfg.transport, stage=ustage,
                                        async_cfg=cfg.async_buffer, sops=sops,
                                        shard_keys=("params", "personal", "ef")),
                    lambda s: layout.unravel(s["personal"]),
                    comm_scheme="broadcast", num_streams=1,
                    injects_faults=cfg.faults is not None, wire_schema=schema)
