"""Wrapper of the Hopper mix kernel (``csrc/mix_aggregate.cu``).

Replaces ``repro.kernels.mix_aggregate.mix_aggregate_pallas``:
``out(k, d) = W(k, m) · θ(m, d)``, W f32, θ f32 or bf16, f32 sums, the
output in θ's dtype. One C entry, one launch a call, two routes, which
:func:`mix_plan` picks from k and m:

* k <= MIX_ROWS and m <= MIX_ROWS, the few-row route (the train step's
  2-4 client rows at LLM width): a streaming kernel that reads θ once in
  its storage dtype, f32 or bf16, 16 bytes at a time (:func:`rows_plan`:
  runs of columns, a block each; at LLM width one sweep of a block's loads
  a run, so the blocks, started in order, stream every row in step);
* else the tile route: the register tiles of ``csrc/mix_tile.cuh``
  (``MIX_TILES``, ``T0``, ``T1`` and ``T2``; :func:`tile_plan`: the tile,
  the grid, the dynamic shared memory), f32 θ only; the wrapper mixes a
  bf16 θ there through an f32 copy and casts the result back.

Each output is one FMA chain from +0 over j = 0 .. m-1 in order on both
routes: an f32 output has the same bits on either, and a bf16 output is
that f32 sum rounded once to nearest-even, the bits of the tile route's
f32 output cast to bf16. Both plans take the 16-byte path when d is a
multiple of the 16-byte pack (4 f32 or 8 bf16) and θ and the output start
on 16-byte boundaries, else the scalar path. The masked mix-scatter
(``masked_mix_scatter.py``) runs the same tiles on :func:`tile_plan`. The
kernel refuses a plan that disagrees with its own layout.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_delta import _sm_count

MIX = _build.Kernel("mix_aggregate.cu", "mix_aggregate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong])

ROUTE_TILES, ROUTE_ROWS = 0, 1  # the C entry's route argument
# the few-row route: csrc/mix_aggregate.cu's mix_rows_kernel takes k, m <=
# MIX_ROWS (W's k·m floats in shared memory) and loads ROW_LOADS packs of
# θ's rows a thread before it sums (row_unroll: max(1, ROW_LOADS // m)
# packs of each row); 256 threads a block, two blocks an SM resident, runs
# of columns a multiple of RUN_ALIGN (whole 16-byte packs of either
# dtype), at least RUN_MIN columns a block (a pack a thread in f32)
MIX_ROWS = 16
ROW_LOADS = 16
ROW_THREADS = 256
ROW_BLOCKS_PER_SM = 2
RUN_ALIGN = 8
RUN_MIN = 4 * ROW_THREADS
SMS = 132  # an H100 SXM's SMs, the plans' default; the wrapper passes the card's own
# θ's dtypes the kernel takes, by element bytes (the tile route: f32 only)
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

BK = 16  # rows of θ a chunk of the kernel's shared-memory ring


class MixTile(NamedTuple):
    """A register tile of the kernel: each of tr x tc threads sums an
    rm x rn block of the output; ``stages`` chunks in the ring; ``minb``
    blocks an SM, the launch bound that caps the registers."""

    rm: int
    rn: int
    tr: int
    tc: int
    stages: int
    minb: int

    @property
    def rows(self) -> int:  # BM: rules a block covers
        return self.rm * self.tr

    @property
    def cols(self) -> int:  # BN: columns a block covers
        return self.rn * self.tc

    @property
    def threads(self) -> int:
        return self.tr * self.tc

    @property
    def smem_bytes(self) -> int:
        """The ring: per stage a transposed (BK, BM) W tile, its rows BM
        floats apart, or BM + 4 where BM / 4 is even (so the stride / 4 is
        odd), and a (BK, BN) θ tile, f32."""
        ws = self.rows if (self.rows // 4) % 2 else self.rows + 4
        return 4 * self.stages * BK * (ws + self.cols)


# the source's T0, T1 and T2, by index: the plan takes T0 when its 4 rows
# cover k, T2 when its 64 rows do, else T1 over ceil(k / 128) row tiles.
MIX_TILES = (
    MixTile(rm=4, rn=4, tr=1, tc=32, stages=4, minb=16),  # k <= 4 (ucfl_k4's centroid rules)
    MixTile(rm=8, rn=8, tr=16, tc=16, stages=3, minb=2),  # k > 64 (full ucfl), 128 rows a tile
    MixTile(rm=8, rn=4, tr=8, tc=32, stages=3, minb=3),   # 5 <= k <= 64 (a 50-slot cohort)
)


class MixPlan(NamedTuple):
    """The tile route's launch."""

    tile: int          # index into MIX_TILES
    vec: bool          # the 16-byte path
    row_tiles: int
    col_tiles: int
    blocks: int        # row_tiles * col_tiles, the row tile fastest
    threads: int
    smem_bytes: int

    route = "tiles"


class MixRowsPlan(NamedTuple):
    """The few-row route's launch."""

    elem: int          # θ's element bytes: 4 (f32) or 2 (bf16)
    vec: bool          # the 16-byte path
    blocks: int        # the grid, a run a block
    run: int           # columns a block, a multiple of RUN_ALIGN; the last block's run ends at d
    threads: int

    route = "rows"


def few_rows(k: int, m: int) -> bool:
    """Whether the few-row route takes a (k, m) W."""
    return k <= MIX_ROWS and m <= MIX_ROWS


def mix_plan(k: int, m: int, d: int, theta_ptr: int, out_ptr: int, *, elem: int = 4,
             sm_count: int = SMS):
    """The launch of ``out(k, d) = W(k, m) · θ(m, d)`` (k, m, d > 0) for θ
    of ``elem`` bytes an element: :func:`rows_plan` at k, m <= MIX_ROWS,
    else :func:`tile_plan` (f32: a bf16 θ there is mixed through an f32
    copy, which the plan then describes)."""
    if min(k, m, d) <= 0:
        raise ValueError(f"mix_plan: k, m, d must be positive, got {(k, m, d)}")
    if elem not in ELEM_BYTES.values():
        raise ValueError(f"mix_plan: θ's elements must be 4 (f32) or 2 (bf16) bytes, got {elem}")
    if few_rows(k, m):
        return rows_plan(k, m, d, theta_ptr, out_ptr, elem, sm_count)
    return tile_plan(k, m, d, theta_ptr, out_ptr)


def sweep_columns(m: int, elem: int) -> int:
    """The columns one pass of a block's loads covers: ROW_THREADS threads,
    each loading ``max(1, ROW_LOADS // m)`` 16-byte packs of every row."""
    return ROW_THREADS * max(1, ROW_LOADS // m) * (16 // elem)


def rows_plan(k: int, m: int, d: int, theta_ptr: int, out_ptr: int, elem: int,
              sm_count: int) -> MixRowsPlan:
    """The few-row route's launch (k, m <= MIX_ROWS): a block a run of
    columns. Where d fills ROW_BLOCKS_PER_SM blocks an SM with a sweep each
    (``sweep_columns``), a run is one sweep, so that the blocks, which the
    card starts in order, stream every row of θ and of the output in one
    moving window; a narrower d is spread over at most that many blocks,
    runs of ``max(RUN_MIN, round_up(ceil(d / (ROW_BLOCKS_PER_SM ·
    sm_count)), RUN_ALIGN))`` columns. The 16-byte path when d is a
    multiple of the pack (16 / elem columns) and θ and out start on 16-byte
    boundaries (every row and run then does), else the scalar path."""
    if not (0 < k <= MIX_ROWS and 0 < m <= MIX_ROWS) or d <= 0 or sm_count <= 0:
        raise ValueError(f"rows_plan: needs 0 < k, m <= {MIX_ROWS} and positive d and "
                         f"sm_count, got {(k, m, d, sm_count)}")
    sweep = sweep_columns(m, elem)
    if d >= ROW_BLOCKS_PER_SM * sm_count * sweep:
        run = sweep
    else:
        want = -(-d // (ROW_BLOCKS_PER_SM * sm_count))
        run = max(RUN_MIN, -(-want // RUN_ALIGN) * RUN_ALIGN)
    vec = d % (16 // elem) == 0 and (theta_ptr | out_ptr) % 16 == 0
    return MixRowsPlan(elem, vec, -(-d // run), run, ROW_THREADS)


def tile_plan(k: int, m: int, d: int, theta_ptr: int, out_ptr: int) -> MixPlan:
    """The tile route's launch (k, m, d > 0, f32 θ): the 4-row tile for
    k <= 4, the 64-row tile for k <= 64, else the 128-row tile over
    ceil(k / 128) row tiles (a warp whose rows all lie past k skips its
    FMAs); the 16-byte path when d % 4 == 0 and θ and out start on 16-byte
    boundaries (every row then does), else the scalar path; one block per
    row tile and 128 columns. m only has to be positive: the ring takes
    any m. The masked mix-scatter plans with ``tile_plan(c, c, d,
    theta_ptr, full_ptr)`` at every c."""
    if min(k, m, d) <= 0:
        raise ValueError(f"tile_plan: k, m, d must be positive, got {(k, m, d)}")
    index = 0 if k <= MIX_TILES[0].rows else 2 if k <= MIX_TILES[2].rows else 1
    t = MIX_TILES[index]
    row_tiles = -(-k // t.rows)
    col_tiles = -(-d // t.cols)
    blocks = row_tiles * col_tiles
    if blocks > 2**31 - 1:
        raise ValueError(f"tile_plan: {blocks} blocks for k={k}, d={d} pass the grid's limit")
    vec = d % 4 == 0 and (theta_ptr | out_ptr) % 16 == 0
    return MixPlan(index, vec, row_tiles, col_tiles, blocks, t.threads, t.smem_bytes)


def mix_aggregate_cuda(w: torch.Tensor, theta: torch.Tensor, *, route=None) -> torch.Tensor:
    """w (k, m), theta (m, d) CUDA tensors, θ float32 or bfloat16 -> (k, d)
    in θ's dtype; raises on another dtype of θ.

    W is cast to float32 like the reference does. The route is
    :func:`mix_plan`'s; ``route="tiles"`` forces the tile route at any
    shape (a check of the routes against each other, never the main path).
    A bf16 θ on the tile route is mixed through an f32 copy, cast back.
    d == 0 or k == 0 returns early without a launch.
    """
    if not (w.is_cuda and theta.is_cuda) or w.device != theta.device:
        raise ValueError("mix_aggregate_cuda: expects both tensors on one CUDA device")
    if w.dim() != 2 or theta.dim() != 2 or w.shape[1] != theta.shape[0]:
        raise ValueError(f"mix_aggregate_cuda: shapes {tuple(w.shape)} x "
                         f"{tuple(theta.shape)} do not chain")
    if theta.dtype not in ELEM_BYTES:
        raise TypeError(f"mix_aggregate_cuda: theta must be float32 or bfloat16, got "
                        f"{theta.dtype}")
    if route not in (None, "tiles"):
        raise ValueError(f"mix_aggregate_cuda: route must be None or 'tiles', got {route!r}")
    k, m = w.shape
    d = theta.shape[1]
    out = torch.empty((k, d), dtype=theta.dtype, device=theta.device)
    if d == 0 or k == 0:
        return out
    if m == 0:
        return out.zero_()
    w = w.to(torch.float32).contiguous()
    theta = theta.contiguous()
    if route is None and few_rows(k, m):
        bf16 = theta.dtype == torch.bfloat16
        plan = rows_plan(k, m, d, theta.data_ptr(), out.data_ptr(), ELEM_BYTES[theta.dtype],
                         _sm_count(theta.device.index))
        MIX(theta.device, _build.ptr(w), _build.ptr(theta), _build.ptr(out), k, m, d,
            ROUTE_ROWS, int(bf16), 0, int(plan.vec), plan.blocks, 0, plan.run)
        return out
    if theta.dtype != torch.float32:
        return mix_aggregate_cuda(w, theta.float(), route="tiles").to(theta.dtype)
    plan = tile_plan(k, m, d, theta.data_ptr(), out.data_ptr())
    MIX(theta.device, _build.ptr(w), _build.ptr(theta), _build.ptr(out), k, m, d, ROUTE_TILES,
        0, plan.tile, int(plan.vec), plan.blocks, plan.smem_bytes, 0)
    return out
