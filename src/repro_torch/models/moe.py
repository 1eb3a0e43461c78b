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

Expert parallelism (:func:`apply_expert_parallel`, the reference's
``shard_map`` path) shards the experts over a rank mesh
(:mod:`repro_torch.launch.mesh`, set with :func:`set_ep_mesh`): E over
the config's ``ep_axis`` ("data"), each expert's d_ff over "model". Each
rank routes its own tokens, buckets the assignments by owner rank, sends
them with an all-to-all, runs its experts' F-shard on the rows it
received, SUMs the partial rows over "model", sends them back and
combines them at the source. ``apply_auto`` takes it exactly when the
config names an expert axis and a mesh is set.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.federated import mesh as mesh_lib
from repro_torch.models.layers import matmul, normal_init


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


# the rank mesh of the expert-parallel path (set by the launcher; None on
# one rank, where the sort dispatch runs)
_EP_MESH = None


def set_ep_mesh(mesh):
    """Deploy the expert-parallel path on ``mesh`` (a
    :class:`repro_torch.launch.mesh.RankMesh`); None clears it."""
    global _EP_MESH
    _EP_MESH = mesh


def ep_mesh():
    """The mesh :func:`set_ep_mesh` set, or None."""
    return _EP_MESH


@dataclasses.dataclass(frozen=True)
class ExpertBlock:
    """The experts [e_lo, e_hi) and d_ff columns [f_lo, f_hi) of an MoE
    layer that :func:`init` builds: the whole stack on one rank, a rank's
    block under expert parallelism (:mod:`repro_torch.launch.sharding`)."""
    e_lo: int
    e_hi: int
    f_lo: int
    f_hi: int


def expert_seed(*parts) -> int:
    """A stable 63-bit seed of ``parts`` (the same in every process)."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def init(gen, cfg: MoEConfig, dtype=torch.float32, device=None, *, block: ExpertBlock = None):
    """One model's MoE weights (no client axis) in the reference's shapes,
    the router in f32, on ``device`` (CUDA when None); matches the
    reference in distribution only. The router and one layer seed come
    from ``gen``; each expert is drawn whole from a generator of its own
    (:func:`expert_seed` of the layer seed, the leaf and the expert) and
    cut to ``block`` (the whole stack when None), so w_gate and w_up are
    (e_hi − e_lo, D, f_hi − f_lo) and w_down (e_hi − e_lo, f_hi − f_lo, D),
    and the blocks of any mesh make up the one-rank model. ``gen`` is
    drawn from the same way whatever the block. On the ``meta`` device
    nothing is drawn (``gen`` may be None): the leaves are empty meta
    tensors of those shapes."""
    device = resolve_device(device)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    block = block or ExpertBlock(0, e, 0, f)
    if device.type == "meta":
        eb, fb = block.e_hi - block.e_lo, block.f_hi - block.f_lo
        return {"router": torch.empty((d, e), dtype=torch.float32, device=device),
                **{k: torch.empty((eb,) + shape, dtype=dtype, device=device)
                   for k, shape in (("w_gate", (d, fb)), ("w_up", (d, fb)),
                                    ("w_down", (fb, d)))}}
    router = normal_init(gen, (d, e), 0.02, torch.float32, device)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))
    cols = slice(block.f_lo, block.f_hi)

    def experts(name, scale, down=False):
        """The block's experts of one leaf, each drawn whole and cut."""
        fb = block.f_hi - block.f_lo
        out = torch.empty((block.e_hi - block.e_lo,) + ((fb, d) if down else (d, fb)),
                          dtype=dtype, device=device)
        own = torch.Generator(device=device)
        for i, ex in enumerate(range(block.e_lo, block.e_hi)):
            own.manual_seed(expert_seed(seed, name, ex))
            w = normal_init(own, (f, d) if down else (d, f), scale, dtype, device)
            out[i] = w[cols] if down else w[:, cols]
        return out

    return {
        "router": router,
        # the reference's fan-in of the (E, D, F) stack: E ** -0.5
        "w_gate": experts("w_gate", e ** -0.5),
        "w_up": experts("w_up", e ** -0.5),
        # fan-in of each expert's (F, D) matrix, as the reference's vmap
        "w_down": experts("w_down", f ** -0.5, down=True),
    }


def capacity(num_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.top_k * num_tokens * cfg.capacity_factor / cfg.num_experts)
    return max(c - c % -8, 8)  # round up to 8


def _route(router, xt, cfg: MoEConfig, *, softcap=True):
    """f32 logits, softmax, top-k and the renormalized weights of tokens
    xt (m, N, D) under router (m, D, E): (probs, top_w, top_ids). The
    expert-parallel path takes no softcap (``softcap=False``), as the
    reference's does not."""
    with _kept(False):  # save_moe recomputes x's f32 copy
        xf = xt.to(torch.float32)
    logits = matmul(xf, router)  # (m, N, E)
    if softcap and cfg.router_softcap:
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


class _WideProduct(torch.autograd.Function):
    """(E, C, K) @ (E, K, N) of bf16 operands, accumulated and returned in
    f32 (the reference's ``preferred_element_type=jnp.float32``); the
    backward's products take the cotangent in the operands' dtype and
    return theirs."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda:
            return torch.bmm(h, w, out_dtype=torch.float32)
        return torch.bmm(h.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        return matmul(g, w.transpose(-1, -2)), matmul(h.transpose(-1, -2), g)


def _experts_mm_f32(h, w):
    """``_experts_mm`` with an f32 result whatever the operands' dtype."""
    if h.dtype == torch.float32:
        return _experts_mm(h, w)
    return torch.stack([_WideProduct.apply(h[i], w[i]) for i in range(w.shape[0])])


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


def expert_load(p, x, cfg: MoEConfig):
    """(m, E) int64: the assignments the router gives each expert, before
    any capacity."""
    m, b, s, d = x.shape
    _, _, top_ids = _route(p["router"], x.reshape(m, b * s, d), cfg)
    return torch.zeros((m, cfg.num_experts), dtype=torch.int64, device=x.device).scatter_add(
        1, top_ids.reshape(m, -1), torch.ones_like(top_ids.reshape(m, -1)))


def dropped_tokens(p, x, cfg: MoEConfig):
    """(m, B, S) bool: the tokens with an assignment that ``apply`` drops."""
    m, b, s, d = x.shape
    _, _, top_ids = _route(p["router"], x.reshape(m, b * s, d), cfg)
    _, order, slot = _dispatch(top_ids, cfg.num_experts)
    hit = torch.zeros(m * b * s, dtype=torch.int32, device=x.device).index_add(
        0, torch.div(order, cfg.top_k, rounding_mode="floor"),
        (slot >= capacity(b * s, cfg)).to(torch.int32))
    return hit.view(m, b, s) > 0


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


def _round8(c: int) -> int:
    return max(c - c % -8, 8)


def ep_capacities(n: int, cfg: MoEConfig, mesh, cf2: float = 1.5) -> tuple[int, int]:
    """(cap, cap2) of the expert-parallel path for a rank's n tokens of one
    client: the rows a source sends each owner rank, round8(k·n·cf/R), and
    the rows an owner keeps for each of its E/R experts,
    round8(min(R·cap·cf2/(E/R), R·cap)). The reference's, from its n =
    (b // R)·s // pods, which is a rank's b_loc·s."""
    r = mesh.shape[cfg.ep_axis]
    e_loc = cfg.num_experts // r
    cap = _round8(int(cfg.top_k * n * cfg.capacity_factor / r))
    return cap, _round8(min(int(r * cap * cf2 / e_loc), r * cap))


@dataclasses.dataclass
class _EPRoute:
    """The routing and both stages' bookkeeping of one expert-parallel call
    (shapes for m clients, n tokens, k choices, R data ranks, E/R local
    experts, the capacities cap and cap2)."""
    probs: torch.Tensor  # (m, n, E) f32
    top_w: torch.Tensor  # (m, n, k) f32
    top1: torch.Tensor  # (m, n) each token's first choice
    dst: torch.Tensor  # (m, n, k) owner rank of each assignment
    order: torch.Tensor  # (m·n·k,) stable sort of the (client, owner) keys
    send_row: torch.Tensor  # (m·n·k,) in sorted order: its row of the (R, m, cap + 1) send buffer
    slot: torch.Tensor  # (m·n·k,) in sorted order: its slot at the owner (>= cap: dropped)
    order2: torch.Tensor  # (m·R·cap,) stable sort of the received rows by (client, expert)
    slot2: torch.Tensor  # (m·R·cap,) in sorted order: its slot in its expert (>= cap2: dropped)
    key2: torch.Tensor  # (m·R·cap,) in sorted order: client·(E/R + 1) + expert (E/R: empty)


def _ep_route(router, xt, cfg: MoEConfig, mesh, cap: int) -> _EPRoute:
    """Route the tokens xt (m, n, D), bucket the assignments by owner rank
    at capacity ``cap``, send the local expert ids over (the first
    all-to-all) and group the rows each owner receives by expert."""
    m, n, _ = xt.shape
    k = cfg.top_k
    data = mesh.axis(cfg.ep_axis)
    r = data.shards
    e_loc = cfg.num_experts // r
    dev = xt.device
    probs, top_w, top_ids = _route(router, xt, cfg, softcap=False)
    # bucket every client's assignments by owner rank: one stable sort of
    # client·R + owner keeps each (client, owner) segment in token order
    dst = torch.div(top_ids, e_loc, rounding_mode="floor")
    key = (dst + r * torch.arange(m, device=dev)[:, None, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    seg = torch.searchsorted(sk, torch.arange(m * r, device=dev), side="left")
    slot = torch.arange(sk.numel(), device=dev) - seg[sk]
    slot_c = torch.clamp(slot, max=cap)  # cap: the discard column
    owner, client = sk % r, torch.div(sk, r, rounding_mode="floor")
    send_row = (owner * m + client) * (cap + 1) + slot_c
    send_e = torch.full(((cap + 1) * r * m,), -1, dtype=torch.int64, device=dev).index_put(
        (send_row,), (top_ids % e_loc).reshape(-1)[order])
    recv_e = mesh_lib.all_to_all(send_e.view(r, m, cap + 1)[:, :, :cap].contiguous(), data)
    # at the owner: group the received rows by (client, local expert), the
    # empties last in each client, in (source rank, slot) order
    re_ = recv_e.permute(1, 0, 2).reshape(-1)
    key2 = (torch.where(re_ >= 0, re_, torch.full_like(re_, e_loc))
            + (e_loc + 1) * torch.arange(m, device=dev).repeat_interleave(r * cap))
    order2 = torch.argsort(key2, stable=True)
    sk2 = key2[order2]
    seg2 = torch.searchsorted(sk2, torch.arange(m * (e_loc + 1), device=dev), side="left")
    slot2 = torch.arange(sk2.numel(), device=dev) - seg2[sk2]
    return _EPRoute(probs, top_w, top_ids[..., 0], dst, order, send_row, slot, order2, slot2,
                    sk2)


def _check_block(p, cfg: MoEConfig, mesh):
    r, mm = mesh.shape[cfg.ep_axis], mesh.shape["model"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    if e % r or f % mm:
        raise ValueError(f"expert parallelism: {e} experts over {r} ranks and d_ff {f} over "
                         f"{mm} do not divide")
    want = (e // r, d, f // mm)
    if tuple(p["w_gate"].shape[-3:]) != want or tuple(p["w_down"].shape[-3:]) != (
            e // r, f // mm, d):
        raise ValueError(f"expert parallelism: w_gate {tuple(p['w_gate'].shape)} is not this "
                         f"rank's (m, {e // r}, {d}, {f // mm}) block "
                         "(repro_torch.launch.sharding.rank_block)")


def apply_expert_parallel(p, x, cfg: MoEConfig, *, cf2: float = 1.5):
    """The expert-parallel MoE on this rank of the mesh :func:`set_ep_mesh`
    set (the reference's ``shard_map`` path). x (m, B_loc, S, D) is this
    rank's slice of the batch (the same on every rank of "model"); the
    router is whole, (m, D, E); the experts are this rank's block, w_gate
    and w_up (m, E/R, D, F/M), w_down (m, E/R, F/M, D)
    (:func:`repro_torch.launch.sharding.rank_block`). Returns (y (m, B_loc,
    S, D), aux (m,) f32).

      1. route the rank's tokens (f32 router, no softcap), bucket the
         assignments by owner rank at capacity ``cap`` (a stable sort:
         the reference's drops), ``all_to_all`` them over the expert axis;
      2. at the owner, group the received rows by local expert at capacity
         ``cap2`` (a stable sort), run SwiGLU on the F-shard (the gate and
         up products and the activation in f32, cast to x's dtype before
         the down product), and SUM the partial rows, in x's dtype, over
         "model";
      3. ``all_to_all`` the rows back and combine each token's k outputs
         in f32, weighted, in the reference's order (by owner rank, then
         choice), with no atomics.

    ``aux`` is E · Σ mean(probs) · mean(one_hot(top1)), both means taken
    over the expert axis's ranks (the reference's ``pmean``). Gradients
    are the reference's: the all-to-all's backward is the reverse
    exchange, the rows' SUM passes each "model" rank its cotangent, and
    the rows entering the F-shard SUM their cotangents over "model"
    (:func:`repro_torch.federated.mesh.axis_copy`), so x's gradient is
    whole on every rank. With no mesh set it raises ``ValueError``."""
    mesh = _EP_MESH
    if mesh is None or cfg.ep_axis is None:
        raise ValueError("apply_expert_parallel needs moe.set_ep_mesh(mesh) and cfg.ep_axis")
    _check_block(p, cfg, mesh)
    data, model = mesh.axis(cfg.ep_axis), mesh.axis("model")
    m, b, s, d = x.shape
    n, k, r = b * s, cfg.top_k, data.shards
    e_loc = cfg.num_experts // r
    cap, cap2 = ep_capacities(n, cfg, mesh, cf2)
    xt = x.reshape(m, n, d)
    with _kept():
        rt = _ep_route(p["router"], xt, cfg, mesh, cap)

    # the Switch aux: the data-axis means of me and ce, in one collective
    me = rt.probs.mean(dim=1)
    ce = (rt.top1[..., None] == torch.arange(cfg.num_experts, device=x.device)).to(
        torch.float32).mean(dim=1)
    means = mesh_lib.axis_mean(torch.stack([me, ce]), data)
    aux = cfg.num_experts * (means[0] * means[1]).sum(-1)

    # 1. the send buffer (R, m, cap + 1, D): column cap collects the drops
    src = xt.reshape(m * n, d)[torch.div(rt.order, k, rounding_mode="floor")]
    send = x.new_zeros((r * m * (cap + 1), d)).index_put((rt.send_row,), src)
    recv = mesh_lib.all_to_all(send.view(r, m, cap + 1, d)[:, :, :cap].contiguous(), data)
    rows_in = mesh_lib.axis_copy(recv, model).permute(1, 0, 2, 3).reshape(m * r * cap, d)

    # 2. the owner's buffer (m, E/R + 1, cap2 + 1, D): expert E/R takes the
    # empties, column cap2 the drops
    row2 = rt.key2 * (cap2 + 1) + torch.clamp(rt.slot2, max=cap2)
    buf = x.new_zeros((m * (e_loc + 1) * (cap2 + 1), d)).index_put(
        (row2,), rows_in[rt.order2])
    hidden = buf.view(m, e_loc + 1, cap2 + 1, d)[:, :e_loc, :cap2]
    # the gate and up products and the SwiGLU in f32, as the reference's
    act = F.silu(_experts_mm_f32(hidden, p["w_gate"])) * _experts_mm_f32(hidden, p["w_up"])
    # (m, E/R, cap2, D): this F-shard's part of each row
    out = _experts_mm(act.to(x.dtype), p["w_down"])
    out = F.pad(out, (0, 0, 0, 1, 0, 1)).reshape(-1, d)  # zero rows for drops and empties
    row2_of = torch.empty_like(row2).scatter(0, rt.order2, row2)  # in (client, source, slot) order
    rows = out[row2_of].view(m, r, cap, d).permute(1, 0, 2, 3).contiguous()
    ret = mesh_lib.all_to_all(mesh_lib.axis_sum(rows, model), data)  # (R, m, cap, D)

    # 3. the combine at the source, in f32: each token's k outputs in the
    # reference's order (by owner rank, then choice), weighted and added,
    # one choice at a time
    ret = F.pad(ret, (0, 0, 0, 1)).reshape(-1, d)  # the discard column reads zero
    row_of = torch.empty_like(rt.send_row).scatter(0, rt.order, rt.send_row).view(m, n, k)
    perm = torch.argsort(rt.dst, dim=-1, stable=True)
    rows_k = torch.take_along_dim(row_of, perm, dim=2)
    w = torch.take_along_dim(rt.top_w, perm, dim=2)
    y = None
    for j in range(k):
        part = ret[rows_k[:, :, j].reshape(-1)].view(m, n, d).to(torch.float32) * w[:, :, j, None]
        y = part if y is None else y + part
    with _kept():  # the layer's output
        y = y.to(x.dtype).view(m, b, s, d)
    return y, aux


def ep_dropped(p, x, cfg: MoEConfig, *, cf2: float = 1.5):
    """What :func:`apply_expert_parallel` drops on this rank: ``(at_cap
    (m,), at_cap2 (m,), tokens (m, B_loc, S) bool)``: this rank's
    assignments past ``cap`` for their owner, the rows it received past
    ``cap2`` for their expert, and its tokens with an assignment dropped at
    either stage (the owners' flags sent back by one more all-to-all)."""
    mesh = _EP_MESH
    data = mesh.axis(cfg.ep_axis)
    m, b, s, d = x.shape
    n, k, r = b * s, cfg.top_k, data.shards
    cap, cap2 = ep_capacities(n, cfg, mesh, cf2)
    with torch.no_grad():
        rt = _ep_route(p["router"], x.reshape(m, n, d), cfg, mesh, cap)
        dev = x.device
        at_cap = torch.zeros(m, dtype=torch.int64, device=dev).index_add(
            0, torch.div(rt.order, n * k, rounding_mode="floor"), (rt.slot >= cap).to(torch.int64))
        real = (rt.key2 % ((cfg.num_experts // r) + 1)) < cfg.num_experts // r
        late = (rt.slot2 >= cap2) & real
        at_cap2 = torch.zeros(m, dtype=torch.int64, device=dev).index_add(
            0, torch.div(rt.key2, cfg.num_experts // r + 1, rounding_mode="floor"),
            late.to(torch.int64))
        # each received row's flag back to its source, in its send slot
        flag = torch.empty_like(late).scatter(0, rt.order2, late)  # (client, source, slot) order
        back = mesh_lib.all_to_all(flag.view(m, r, cap).permute(1, 0, 2).to(torch.int32)
                                   .contiguous(), data)
        back = torch.cat([back, back.new_ones((r, m, 1))], dim=2).reshape(-1)  # cap: dropped
        hit = back[rt.send_row]  # sorted order
        tokens = torch.zeros(m * n, dtype=torch.int32, device=dev).index_add(
            0, torch.div(rt.order, k, rounding_mode="floor"), hit)
    return at_cap, at_cap2, tokens.view(m, b, s) > 0


def apply_auto(p, x, cfg: MoEConfig):
    """The expert-parallel path when the config names an expert axis and a
    mesh is set (:func:`set_ep_mesh`); else the sort dispatch."""
    if cfg.ep_axis is not None and _EP_MESH is not None:
        return apply_expert_parallel(p, x, cfg)
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
