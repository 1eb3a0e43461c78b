"""The client mesh over ``torch.distributed``: the cohort's slots and the
server state's rows partitioned across ranks.

Execution model: SPMD over processes. Every rank runs the same host
program on the same seeds, so the cohorts (numpy), the batch orders (an
identically seeded ``torch.Generator``), the fault draws, W and the
(c, c) mix rules come out the same on every rank by construction. A
sharded cohort round then:

  1. trains the rank's contiguous block of the padded cohort's slots
     (:func:`shard_clients`, used by
     :func:`repro_torch.federated.client.make_federated_local_sgd`);
  2. all-gathers the (c/s, W) updates into the (c, W) upload slab;
  3. runs the (c, c) mix and the fused scatter on its own copy of the
     (m, W) state, or, with ``FedConfig.shard_state``, on its own
     (m/s, W) block of it (the row-sharded section below).

:func:`pad_cohort` rounds every cohort up to a shard multiple with
sentinel pad slots (index m, mask False), which the masked engine treats
as invisible, so every rank trains the same number of slots.

The knob (``FedConfig.mesh``, :func:`resolve`) takes ``None`` (off), a
:class:`ClientMesh`, an int shard count, or ``"auto"`` (the default
process group's world size). ``mesh=1`` needs no process group: its
collectives are the identity, as the reference's one-device mesh. An int
s > 1, or ``"auto"``, needs an initialized default group of s ranks;
``torchrun --nproc-per-node=N`` starts N ranks on N GPUs (NCCL), and
:func:`spawn` starts s ranks in this host for the tests (gloo, on the CPU
or sharing one card).

Collectives: a SUM all-reduce and a row all-gather
(``all_gather_into_tensor``) for the client mesh; for the expert-parallel
MoE on one axis of a 2-D mesh (:mod:`repro_torch.launch.mesh`), an
all-to-all of a leading rank axis (``all_to_all_single``) and the SUM and
mean over the axis, each differentiable as the reference's ``shard_map``
collectives are. All run on the tensors where they lie. NCCL takes CUDA
tensors; gloo takes CPU tensors and, in the torch 2.11 build for CUDA
12.8, CUDA tensors too (it copies them through the host itself; the
all-to-all and bf16 sums as well), so no collective is staged here.
:data:`STATS` counts each collective's calls, bytes and, with
:data:`TIMING` on, its milliseconds (the device synchronized around it).
On a dry mesh (a :class:`DryGroup` in place of the process group) each
collective returns a meta tensor of its result's shape and records itself
in :mod:`repro_torch.launch.op_analysis`'s counter.

The reference's XLA placement helpers (``slot_sharding``,
``replicated_sharding``, ``row_sharding``, ``constrain_rows``,
``commit_replicated``) have no meaning here: a rank holds plain tensors.
Their counterparts are the rank's block bounds (:meth:`ClientMesh.block`)
and :func:`commit_rows`'s divisibility check.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_lib
import time
import traceback
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.federated import participation

# per process: {collective: {"calls", "bytes", "ms"}}
STATS: dict = {}
# synchronize the device around each collective and record its ms
TIMING = False


@dataclasses.dataclass(frozen=True, eq=False)
class ClientMesh:
    """One rank's view of the 1-D ``clients`` mesh: the process group (None
    for one shard, whose collectives are the identity), this rank and the
    shard count."""

    group: Any
    rank: int
    shards: int

    def block(self, rows: int) -> tuple[int, int]:
        """This rank's contiguous row block ``[lo, hi)`` of ``rows`` rows."""
        mb = int(rows) // self.shards
        return self.rank * mb, (self.rank + 1) * mb


def client_mesh(num_shards=None) -> ClientMesh:
    """The mesh over the default process group (the one
    ``init_process_group`` made): ``num_shards`` None means all of its
    ranks, which needs an initialized group; an int s > 1 needs a group of
    exactly s ranks; 1 needs none and runs no collective."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    if num_shards is None and group is None:
        raise ValueError(
            "FedConfig.mesh='auto' needs an initialized torch.distributed process group "
            "(torchrun, or init_process_group); none is initialized")
    s = world if num_shards is None else int(num_shards)
    if not 1 <= s <= world:
        raise ValueError(f"need 1 <= num_shards <= {world} local devices, got {num_shards}")
    if 1 < s < world:
        raise ValueError(
            f"a {s}-shard client mesh needs a process group of {s} ranks, got {world}: "
            "every rank of the group is one shard")
    if num_shards is not None and s == 1:
        group = None  # mesh=1: no collectives, as the reference's one-device mesh
    return ClientMesh(group, 0 if group is None else dist.get_rank(group), s)


def resolve(mesh):
    """Normalize the ``FedConfig.mesh`` knob to a :class:`ClientMesh` (or
    None): ``None``, a ``ClientMesh``, an int shard count (1 needs no
    process group), or ``"auto"`` (every rank of the default group)."""
    if mesh is None or isinstance(mesh, ClientMesh):
        return mesh
    if mesh == "auto":
        return client_mesh()
    return client_mesh(int(mesh))


def num_shards(mesh) -> int:
    return int(mesh.shards)


def pad_to_shards(slots: int, shards: int) -> int:
    """Round a slot count up to the next multiple of the shard count."""
    return -(-int(slots) // int(shards)) * int(shards)


def pad_cohort(cohort: participation.Cohort, mesh, m: int) -> participation.Cohort:
    """Pad a cohort's slot count to a multiple of the mesh's shard count
    with sentinel pad slots (index m, mask False), invisible to the masked
    engine. No-op when already divisible (one shard in particular)."""
    return participation.pad_slots(cohort, pad_to_shards(cohort.num_slots, num_shards(mesh)), m)


# ------------------------------------------------------------- collectives


def reset_stats():
    STATS.clear()


def _start(t):
    if not TIMING:
        return None
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


def _record(name, t, t0):
    st = STATS.setdefault(name, {"calls": 0, "bytes": 0, "ms": 0.0})
    st["calls"] += 1
    st["bytes"] += t.numel() * t.element_size()
    if t0 is not None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        st["ms"] += (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass(frozen=True)
class DryGroup:
    """The group of a dry mesh (:func:`repro_torch.launch.mesh.make_dry_mesh`):
    its size, and no processes. A collective over it returns meta tensors
    of the shapes the real one returns and records itself in the active
    :func:`repro_torch.launch.op_analysis.counting` (``RuntimeError``
    outside one, or on tensors that are not meta)."""

    size: int


def _dry(kind, out, mesh):
    """Record a collective of a dry mesh; True when ``mesh`` is one."""
    if not isinstance(mesh.group, DryGroup):
        return False
    from repro_torch.launch import op_analysis
    op_analysis.record_collective(kind, out, mesh.shards)
    return True


def all_reduce_sum(t, mesh):
    """SUM all-reduce of ``t`` over the mesh, in place; returns ``t``. The
    identity on one shard."""
    if mesh.group is None or _dry("all-reduce", t, mesh):
        return t
    t0 = _start(t)
    dist.all_reduce(t, group=mesh.group)
    _record("all_reduce", t, t0)
    return t


def all_gather_rows(x, mesh):
    """Every rank's ``x`` stacked along the rows in rank order: (s·rows,
    ...). The identity on one shard. Bool tensors travel as uint8."""
    if mesh.group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8), mesh).bool()
    x = x.contiguous()
    out = x.new_empty((mesh.shards * x.shape[0],) + tuple(x.shape[1:]))
    if _dry("all-gather", out, mesh):
        return out
    t0 = _start(x)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    _record("all_gather", out, t0)
    return out


def _all_to_all(x, mesh):
    x = x.contiguous()
    out = torch.empty_like(x)
    if _dry("all-to-all", out, mesh):
        return out
    t0 = _start(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    _record("all_to_all", out, t0)
    return out


def _reduce(x, mesh, name):
    x = x.clone()
    if _dry("all-reduce", x, mesh):
        return x
    t0 = _start(x)
    dist.all_reduce(x, group=mesh.group)
    _record(name, x, t0)
    return x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh), None  # the reverse exchange


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _reduce(x, mesh, "axis_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None  # the axis's ranks hold the same downstream: no second SUM


class _AxisCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, "axis_sum"), None


class _AxisMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce(x, mesh, "axis_mean") / mesh.shards

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, "axis_mean") / ctx.mesh.shards, None


def all_to_all(x, mesh):
    """The all-to-all of ``x``'s leading axis, one slice a rank: out[j] is
    what rank j of the mesh sent as its x[this rank] (``x.shape[0]`` must be
    the shard count). Differentiable: the backward is the reverse exchange.
    The identity on one shard."""
    if mesh.group is None:
        return x
    if x.shape[0] != mesh.shards:
        raise ValueError(f"all_to_all: the leading axis is {x.shape[0]}, the mesh has "
                         f"{mesh.shards} ranks")
    return _AllToAll.apply(x, mesh)


def axis_sum(x, mesh):
    """The SUM of ``x`` over the mesh's ranks (a new tensor). Differentiable
    as the reference's ``psum`` of an output replicated over the axis is
    under ``shard_map``: each rank gets the cotangent unchanged (the ranks
    hold replicas of everything after the sum; a second SUM would count the
    cotangent once a rank). The identity on one shard."""
    return x if mesh.group is None else _AxisSum.apply(x, mesh)


def axis_copy(x, mesh):
    """``x`` itself, entering work that each rank does on its shard (the
    experts' d_ff): the backward SUMs the ranks' cotangents, as the
    reference sums the cotangent of an input replicated over the axis. The
    identity on one shard."""
    return x if mesh.group is None else _AxisCopy.apply(x, mesh)


def axis_mean(x, mesh):
    """The mean of ``x`` over the mesh's ranks (SUM, then divided by the
    shard count). Differentiable as the reference's ``pmean``: the
    backward is the mean of the cotangents. The identity on one shard."""
    return x if mesh.group is None else _AxisMean.apply(x, mesh)


def check_spmd(mesh, **tensors):
    """Raise ``RuntimeError`` unless every rank holds the same values in each
    named tensor: the cheap check of SPMD drift (the cohort's slots, a
    batch order), all-gathered once, not run on the hot path."""
    for name, t in tensors.items():
        t = torch.as_tensor(t).reshape(1, -1)
        got = all_gather_rows(t, mesh)
        if not bool((got == got[0:1]).all()):
            raise RuntimeError(f"SPMD drift: ranks hold different {name!r}: "
                               f"{got.cpu().numpy().tolist()}")


# ------------------------------------------------------------- client axis


def _rows(tree, sl):
    """Slice the leading axis of every tensor of ``tree`` (a tensor, a
    tuple of them or None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_rows(t, sl) for t in tree)
    return tree[sl]


def shard_clients(fn, mesh):
    """``mapped(*args)``: ``fn`` on this rank's contiguous block of the
    leading client (slot) axis of every argument (tensors, tuples of them,
    None passing through), its outputs (a tensor or a tuple of them)
    all-gathered back along the rows in rank order. The caller checks that
    the shard count divides the axis. Each row is computed as the
    unsharded call computes it; only the local batch shape changes."""

    def mapped(*args):
        if mesh.group is None:
            return fn(*args)
        rows = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]
        lo, hi = mesh.block(rows)
        out = fn(*(_rows(a, slice(lo, hi)) for a in args))
        if isinstance(out, tuple):
            return tuple(all_gather_rows(o, mesh) for o in out)
        return all_gather_rows(out, mesh)

    return mapped


# ------------------------------------------------------- row-sharded state
#
# With ``FedConfig.shard_state`` each rank holds rows [k·m/s, (k+1)·m/s) of
# every (m, ·) state slab the strategy names (``shard_keys``), so server
# memory and per-round traffic scale down with the rank count. A cohort row
# is routed to its owner: the gather is a (c, W) SUM all-reduce of
# one-hot-owned rows (exact: one owner per row, zeros elsewhere), and the
# scatter and the fused mix-scatter write only the owner's block
# (localized ids; the rest drop on the local sentinel m/s). The only
# model-sized collectives are O(c·W) (and the async buffer's flush, an
# all-gather of its (B, W) rows); never O(m·W).

# the state key that marks a row-sharded state: the RowMesh its
# ``shard_keys`` slabs are row-sharded over
ROW_KEY = "row_mesh"


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh(ClientMesh):
    """The mark of a row-sharded state (under :data:`ROW_KEY`): the client
    mesh its slabs are row-sharded over, and the state keys of those slabs
    (``keys``; "abuf" for the async buffer's ``upd``)."""

    keys: tuple = ()


def row_mark(mesh, state, shard_keys) -> RowMesh:
    """The :class:`RowMesh` of ``state`` row-sharded over ``mesh``: the
    ``shard_keys`` it holds, and "abuf" where it has a buffer."""
    keys = tuple(k for k in shard_keys if isinstance(state.get(k), torch.Tensor))
    if state.get("abuf") is not None:
        keys += ("abuf",)
    return RowMesh(mesh.group, mesh.rank, mesh.shards, keys)


def row_mesh(state):
    """The mesh a row-sharded ``state`` is sharded over, or None."""
    return state.get(ROW_KEY) if isinstance(state, dict) else None


def gather_state(state):
    """The whole state of a row-sharded ``state``, on every rank: each
    marked slab's blocks all-gathered in rank order, the async buffer's
    ``upd`` blocks without their spare rows and one zero spare row after
    them (a row nothing reads), and no :data:`ROW_KEY`. Bit for bit the
    replicated run's slabs. A state that is not row-sharded comes back as
    it is."""
    mark = row_mesh(state)
    if mark is None:
        return state
    out = {k: v for k, v in state.items() if k != ROW_KEY}
    for k in mark.keys:
        if k == "abuf":
            upd = all_gather_rows(state["abuf"]["upd"][:-1], mark)
            out["abuf"] = dict(state["abuf"], upd=torch.cat([upd, upd.new_zeros((1,) + tuple(
                upd.shape[1:]))]))
        else:
            out[k] = all_gather_rows(state[k], mark)
    return out


def whole_like(state):
    """Empty tensors shaped as :func:`gather_state` of ``state`` would be
    (on each marked slab), for a restore's shapes: the state itself when
    it is not row-sharded."""
    mark = row_mesh(state)
    if mark is None:
        return state
    out = {k: v for k, v in state.items() if k != ROW_KEY}
    for k in mark.keys:
        x = state["abuf"]["upd"] if k == "abuf" else state[k]
        rows = (x.shape[0] - 1) * mark.shards + 1 if k == "abuf" else x.shape[0] * mark.shards
        full = x.new_empty((rows,) + tuple(x.shape[1:]))
        out[k] = dict(state["abuf"], upd=full) if k == "abuf" else full
    return out


def commit_state(whole, like):
    """This rank's state from a whole one: each slab ``like``'s mark names
    cut to the rank's block (the async buffer's ``upd`` with a zero spare
    row), marked as ``like`` is. ``whole`` itself when ``like`` is not
    row-sharded."""
    mark = row_mesh(like)
    if mark is None:
        return whole
    out = dict(whole)
    for k in mark.keys:
        if k == "abuf":
            upd = whole["abuf"]["upd"]
            lo, hi = mark.block(upd.shape[0] - 1)
            out["abuf"] = dict(whole["abuf"], upd=torch.cat([upd[lo:hi],
                                                              upd.new_zeros((1, upd.shape[1]))]))
        else:
            out[k] = commit_rows(whole[k], mark, whole[k].shape[0])
    out[ROW_KEY] = mark
    return out


def barrier(mesh):
    """Wait for every rank of the mesh (nothing on one shard)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def commit_rows(x, mesh, m):
    """This rank's (m/s, ·) block of the (m, ·) slab ``x`` (a copy, so the
    full slab can go), or ``x`` itself when it is the block already."""
    s = num_shards(mesh)
    if m % s or x.shape[0] not in (m, m // s):
        raise ValueError(
            f"row-sharded state needs a leading axis divisible by the "
            f"{s}-device mesh, got shape {tuple(x.shape)} (pad m to a shard "
            f"multiple or drop FedConfig.shard_state)")
    if x.shape[0] != m or s == 1:
        return x
    lo, hi = mesh.block(m)
    return x[lo:hi].clone()


def _localize(idx, mb: int, rank: int):
    """Global row ids -> this rank's block-local ids: ``(loc, own)``, where
    ``own`` marks the slots this rank owns and ``loc`` is their local row
    (the rest, the global sentinel m included, get the local sentinel
    ``mb``, which every scatter drops)."""
    lo = rank * mb
    own = (idx >= lo) & (idx < lo + mb)
    return torch.where(own, idx - lo, torch.full_like(idx, mb)), own


def shard_gather_rows(block, safe, mesh):
    """Cohort gather from a row-sharded slab: each rank gathers the rows it
    owns (one ``cohort_gather`` launch at localized, clamped ids), zeroes
    the rest, and a (c, W) SUM all-reduce assembles the cohort on every
    rank. ``safe`` is pre-clamped (``aggregation.safe_gather_index``), as
    the replicated gather's. Exact: x + 0 is x (−0 comes back as +0)."""
    from repro_torch.core import aggregation
    mb = block.shape[0]
    lo = mesh.rank * mb
    own = (safe >= lo) & (safe < lo + mb)
    loc = torch.clamp(safe - lo, 0, mb - 1).to(torch.int32)
    part = aggregation.cohort_gather(block, loc)
    part = torch.where(own[:, None], part, torch.zeros((), dtype=part.dtype, device=part.device))
    return all_reduce_sum(part, mesh)


def _device_index(arr, dev):
    """Host int64 ids on ``dev`` in one copy (from pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.int64))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def shard_scatter_rows(block, members, rows, mesh):
    """Cohort scatter into a row-sharded slab: ``members`` (host ids of the
    cohort's real prefix) whose rows this rank owns write ``rows[i]`` at
    their local row; the rest drop (the reference's local sentinel m/s).
    No collective: the rows are already on every rank. On the card the
    block is written in place, on the CPU a copy is returned."""
    mb = block.shape[0]
    lo = mesh.rank * mb
    members = np.asarray(members, np.int64)
    sel = np.flatnonzero((members >= lo) & (members < lo + mb))
    out = block if block.is_cuda else block.clone()
    if sel.size:
        both = _device_index(np.concatenate([sel, members[sel] - lo]), block.device)
        out.index_copy_(0, both[sel.size:], rows[both[: sel.size]].to(block.dtype))
    return out


def shard_block_update(fn, mesh):
    """``update(block, idx, mask, *args)``: ``fn(block, loc, mask & own,
    *args)`` on this rank's row block, with ``idx`` localized (non-owned
    slots get the local sentinel and a False mask, so the fused masked
    kernels apply unchanged to the block)."""

    def update(block, idx, mask, *args):
        loc, own = _localize(idx, block.shape[0], mesh.rank)
        return fn(block, loc, mask & own, *args)

    return update


def shard_broadcast_rows(block, mixed, alive):
    """FedAvg-family broadcast into a row-sharded slab: every row of the
    rank's block takes the (1, W) mix, or keeps its value where ``alive``
    (a device bool) is False. No collective."""
    return torch.where(alive, mixed.expand_as(block), block)


def row_mean(block, mesh, m):
    """The mean over all m rows of a row-sharded slab, (1, W): each rank's
    column sum over its block, all-gathered, added in rank order, over m.
    :func:`block_mean` computes the same from a whole slab, bit for bit."""
    part = all_gather_rows(torch.sum(block, dim=0, keepdim=True), mesh)
    return _ordered_sum(part) / m


def block_mean(full, mesh):
    """:func:`row_mean` of the whole (m, W) slab ``full`` on one rank: the
    same block sums, added in the same order."""
    m = full.shape[0]
    mb = m // mesh.shards
    part = torch.cat([torch.sum(full[r * mb:(r + 1) * mb], dim=0, keepdim=True)
                      for r in range(mesh.shards)])
    return _ordered_sum(part) / m


def _ordered_sum(part):
    acc = part[0:1]
    for r in range(1, part.shape[0]):
        acc = acc + part[r:r + 1]
    return acc


# ------------------------------------------------------------------ spawn


def _rank_main(rank, fn, shards, backend, device, store_path, args, results):
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{store_path}",
                                world_size=shards, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # the parent re-raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, shards: int, *, backend: str = "gloo", device=None, store_path: str,
          timeout: float = 300.0, args=()):
    """Run ``fn(rank, *args)`` in ``shards`` fresh processes (the ``spawn``
    start method: CUDA cannot run in a forked child) joined in one process
    group over ``file://store_path``, TF32 off in each; returns the ranks'
    results in rank order. ``fn`` and ``args`` must pickle (a module-level
    function). A rank that raises, or a run that outlives ``timeout``
    seconds, terminates every rank and raises here. The port's counterpart
    of forcing host devices; ``torchrun`` starts the ranks of a real
    multi-GPU run."""
    import torch.multiprocessing as mp
    if os.path.exists(store_path):
        os.unlink(store_path)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, shards, backend, device, store_path, args, results),
                         daemon=True) for r in range(shards)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < shards:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"mesh.spawn: {shards} ranks did not finish in {timeout} s "
                                   f"(ranks done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if not p.is_alive() and r not in out]
                if dead and results.empty():
                    raise RuntimeError(f"mesh.spawn: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"mesh.spawn: rank {rank} raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
    return [out[r] for r in range(shards)]
