"""Mixture-of-Experts layer with sort-based grouped dispatch
(``repro.models.moe``).

The assignments are sorted by expert id and each expert's tokens go into
a fixed-capacity (E, C, D) buffer, so memory is linear in the tokens:

  1. router top-k -> ids (N, k), weights (N, k), the router in f32;
  2. a stable argsort of the flattened ids groups tokens by expert;
  3. slot-in-expert = rank - segment start (``searchsorted``);
  4. tokens go into (E, C + 1, D); a slot >= C goes to the discard column
     (the token is dropped; ``capacity_factor`` sets the drop rate);
  5. per-expert SwiGLU as three batched products over the (E, C, D) buffer;
  6. each token gathers its k expert outputs and adds them, weighted.

The port runs m models at once: leaves carry a leading client axis
(router (m, D, E), w_gate and w_up (m, E, D, F), w_down (m, E, F, D)) and
x is (m, B, S, D). The client folds into the sort key (client·E + expert)
and into the buffer, (m·E, C + 1, D). The sort is stable, so each
client's segment keeps the reference's per-client order, and the same
assignments drop; C is the capacity of one client's B·S tokens.

The combine is deterministic: no atomics. Each token gathers its k expert
outputs (a dropped one reads the zero discard row), multiplies each by
its weight rounded to x's dtype, and adds them in order in x's dtype, as
the reference's scatter-add into a zero buffer does (at top-2 bit for bit
whatever the order of its two adds).

Expert parallelism shards the expert axis over a 2-D (data, model)
device mesh with an all-to-all, which the port does not have yet (its
client mesh, :mod:`repro_torch.federated.mesh`, is 1-D): ``apply_auto``
takes ``apply`` while no mesh is set, and ``set_ep_mesh`` and
``apply_expert_parallel`` raise.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import fan_in_init, matmul, normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_softcap: float | None = None
    ep_axis: str | None = None  # mesh axis for expert parallelism


# set while apply() computes what remat_policy="save_moe" keeps for the
# backward: the routing, the dispatch's indices and the layer's output;
# the (m·E, C + 1, D) buffer and the expert products are recomputed
_SAVING = False


@contextlib.contextmanager
def _kept(on=True):
    global _SAVING
    before, _SAVING = _SAVING, on
    try:
        yield
    finally:
        _SAVING = before


def saving() -> bool:
    """True while an MoE layer computes a tensor that
    ``remat_policy="save_moe"`` keeps for the backward."""
    return _SAVING


def set_ep_mesh(mesh):
    raise NotImplementedError("moe.set_ep_mesh: expert parallelism shards the experts over a "
                              "2-D (data, model) device mesh, which waits for ROADMAP queue "
                              "A's item A5, the 2-D mesh for expert parallelism")


def init(gen, cfg: MoEConfig, dtype=torch.float32, device=None):
    """One model's MoE weights (no client axis) in the reference's shapes,
    the router in f32, on ``device`` (CUDA when None); matches the
    reference in distribution only."""
    device = resolve_device(device)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal_init(gen, (d, e), 0.02, torch.float32, device),
        "w_gate": fan_in_init(gen, (e, d, f), dtype, device),
        "w_up": fan_in_init(gen, (e, d, f), dtype, device),
        # fan-in of each expert's (F, D) matrix, as the reference's vmap
        "w_down": normal_init(gen, (e, f, d), f ** -0.5, dtype, device),
    }


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.top_k * num_tokens * cfg.capacity_factor / cfg.num_experts)
    return max(c - c % -8, 8)  # round up to 8


def _route(router, xt, cfg: MoEConfig):
    """f32 logits, softmax, top-k and the renormalized weights of tokens
    xt (m, N, D) under router (m, D, E): (probs, top_w, top_ids)."""
    with _kept(False):  # save_moe recomputes x's f32 copy
        xf = xt.to(torch.float32)
    logits = matmul(xf, router)  # (m, N, E)
    if cfg.router_softcap:
        logits = cfg.router_softcap * torch.tanh(logits / cfg.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_ids


def _aux(probs, top_ids, e):
    """(m,) Switch-style load-balance loss: E · Σ mean(probs) · mean(one_hot(top1))."""
    me = probs.mean(dim=1)
    one_hot = top_ids[..., :1] == torch.arange(e, device=top_ids.device)  # out of place
    ce = one_hot.to(torch.float32).mean(dim=1)
    return e * (me * ce).sum(-1)


def _experts_mm(h, w):
    """(m, E, C, K) @ (m, E, K, N): one product batched over the experts
    for each client (w is a group's view of the stacked blocks)."""
    return torch.stack([matmul(h[i], w[i]) for i in range(w.shape[0])])


def _dispatch(top_ids, e):
    """The sort dispatch of (m, N, k) expert ids: the client folds into the
    key (client·E + expert), one stable sort serves every client. Returns
    (key, order, slot): each assignment's key in token order, the sorting
    permutation, and each sorted assignment's slot in its expert (the
    capacity or past it: dropped)."""
    m = top_ids.shape[0]
    dev = top_ids.device
    key = (top_ids + e * torch.arange(m, device=dev)[:, None, None]).reshape(-1)  # (m·N·k,)
    order = torch.argsort(key, stable=True)
    seg_start = torch.searchsorted(key[order], torch.arange(m * e, device=dev), side="left")
    slot = torch.arange(key.numel(), device=dev) - seg_start[key[order]]
    return key, order, slot


def dropped(p, x, cfg: MoEConfig):
    """(m,) int64: each client's assignments that ``apply`` drops, past
    the capacity of its B·S tokens."""
    m, b, s, d = x.shape
    _, _, top_ids = _route(p["router"], x.reshape(m, b * s, d), cfg)
    key, order, slot = _dispatch(top_ids, cfg.num_experts)
    client = key[order] // cfg.num_experts
    return torch.zeros(m, dtype=torch.int64, device=x.device).index_add(
        0, client, (slot >= capacity(b * s, cfg)).to(torch.int64))


def apply(p, x, cfg: MoEConfig):
    """x (m, B, S, D) -> (y (m, B, S, D), aux (m,) f32)."""
    m, b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.top_k
    c = capacity(n, cfg)
    xt = x.reshape(m, n, d)
    with _kept():
        probs, top_w, top_ids = _route(p["router"], xt, cfg)
        aux = _aux(probs, top_ids, e)
        key, order, slot = _dispatch(top_ids, e)
        s_key = key[order]
        s_tok = order // k  # the (client·N + token) row of each sorted assignment
        slot_c = torch.where(slot < c, slot, c)  # overflow -> discard column
        slot_of = torch.empty_like(slot_c).scatter(0, order, slot_c)  # in token order

    # dispatch: (m·E, C + 1, D); the discard column c collects dropped tokens
    buf = x.new_zeros((m * e, c + 1, d)).index_put((s_key, slot_c), xt.reshape(m * n, d)[s_tok])
    hidden = buf[:, :c].view(m, e, c, d)

    act = F.silu(_experts_mm(hidden, p["w_gate"])) * _experts_mm(hidden, p["w_up"])
    out = _experts_mm(act, p["w_down"])  # (m, E, C, D)

    # combine: each assignment reads its expert output (zero if dropped)
    out_pad = torch.cat([out.reshape(m * e, c, d), x.new_zeros((m * e, 1, d))], dim=1)
    gathered = out_pad[key, slot_of].view(m, n, k, d)
    weighted = gathered * top_w.to(x.dtype)[..., None]
    y = weighted[:, :, 0]
    for j in range(1, k - 1):
        y = y + weighted[:, :, j]
    with _kept():  # the layer's output
        y = y + weighted[:, :, k - 1] if k > 1 else y.clone()
    return y.view(m, b, s, d), aux


def apply_expert_parallel(p, x, cfg: MoEConfig, *, cf2: float = 1.5):
    raise NotImplementedError("moe.apply_expert_parallel: the all-to-all dispatch runs over a "
                              "2-D (data, model) device mesh, which waits for ROADMAP queue A's "
                              "item A5, the 2-D mesh for expert parallelism")


def apply_auto(p, x, cfg: MoEConfig):
    """The expert-parallel path when deployed with an expert axis on a
    mesh; the port has no mesh yet, so ``apply``."""
    return apply(p, x, cfg)


def apply_reference(p, x, cfg: MoEConfig):
    """O(E·N) oracle: every expert on every token, masked combine in f32.
    Validates the sort-based dispatch (drops aside). x (m, B, S, D) -> y."""
    m, b, s, d = x.shape
    xt = x.reshape(m, b * s, d)
    _, top_w, top_ids = _route(p["router"], xt, cfg)
    outs = []
    for i in range(cfg.num_experts):
        act = F.silu(matmul(xt, p["w_gate"][:, i])) * matmul(xt, p["w_up"][:, i])
        outs.append(matmul(act, p["w_down"][:, i]))
    all_out = torch.stack(outs, dim=2).to(torch.float32)  # (m, N, E, D)
    w_full = torch.zeros(top_ids.shape[:2] + (cfg.num_experts,), dtype=torch.float32,
                         device=x.device).scatter(-1, top_ids, top_w)
    y = torch.einsum("mne,mned->mnd", w_full, all_out)
    return y.reshape(m, b, s, d).to(x.dtype)
